"""The round's frozen work bound (portbench/roofline.py) over the program's
device busy time per mul call (%)."""


def read(rec):
    if rec.device is None:
        return None
    per_call = rec.device.busy_s(program_only=True) / rec.device.n_calls
    return 100.0 * rec.bound_s / per_call
