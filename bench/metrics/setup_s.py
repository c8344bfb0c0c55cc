"""setup_s: seconds from the run's start (before torch is imported) to
the first timed call: imports, the CUDA context, loading (the first run
in a checkout: building) the port's kernel library, the weights, the
warm-up of the cell's shapes, and the decode cell's prefill."""


def read(view):
    return view.setup_s
