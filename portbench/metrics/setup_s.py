"""Process start to the window's start: imports, the CUDA context, the
kernels' libraries, the seeded weights and clips, the tracker's init and
graph captures, the stream's start and its warm-up."""


def read(run):
    return run.setup_s
