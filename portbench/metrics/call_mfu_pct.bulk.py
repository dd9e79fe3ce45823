"""The round's frozen work bound over the mean wall time of a whole mul
call (%)."""


def read(rec):
    return 100.0 * rec.bound_s * rec.n_calls / sum(rec.call_s)
