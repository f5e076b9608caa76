"""The largest device memory the program held in a call of the window,
GiB: ``torch.cuda.max_memory_allocated`` over each call (reset before it),
less what the harness held on the device during that call (its copy of the
weights for the reference, the call's draws, the clouds recorded so far;
``cell.held_bytes``). The largest of these over the window's calls."""


def read(run):
    return run.program_peak_bytes / 2 ** 30
