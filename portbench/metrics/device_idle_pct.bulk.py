"""100 x (1 - the program's device busy time / traced window), from the
profiler; the benchmark's own device work is left out (%)."""


def read(rec):
    if rec.device is None:
        return None
    return 100.0 * (1.0 - rec.device.busy_s(program_only=True)
                     / rec.device.window_s)
