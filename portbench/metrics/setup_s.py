"""Process start to the first timed call (s): imports, CUDA context, kernel
load or build, generate, the operand pool or traces, the warm-up calls."""


def read(rec):
    return rec.setup_s
