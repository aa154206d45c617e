"""The program's entry points that traffic mixes drive: one module per
entry, named by a mix's "entry". Each has setup(cell) -> state (all the
work before the window, warm-up included), window(state, seconds,
trace) -> record (the measured window, or with trace the traced run),
and check(state, record) -> ([(name, value, limit, ok)], the reference's
errors, the number of outputs found wrong): the comparison with the
plain reference after the window."""
