"""setup_s: seconds from the process's start to the window's: imports,
the card, the inputs, the builds of a first run, the warm-up."""


def read(rec):
    return rec["setup_s"]
