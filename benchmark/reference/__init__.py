"""The benchmark's plain H.264 decoder, which decides `correct`.

Plain NumPy and Python: it imports nothing of the program under test
(openh264_tpu_torch), of the JAX package, or of JAX, and takes nothing
the program has made. Its parsers, intra predictors, bS rules and
tables are frozen copies of the port's pure-Python oracles, with the
host C calls replaced by their Python twins; its motion compensation
and deblocking filter are NumPy rewrites of the port's plain PyTorch
versions. See decoder.PlainDecoder.
"""

from .decoder import PlainDecoder  # noqa: F401
