"""The largest device memory the program held during the window
(``torch.cuda.max_memory_allocated``, reset at the window's start), GiB."""


def read(run):
    return run.window_peak_bytes / 2 ** 30
