"""One OpenMP width for both packages' native samplers.

Each package's ``sampler_core`` keeps a process-wide OpenMP width, and
its Gumbel top-k draws follow it: the candidates are split by the width
and each thread seeds its own generator. A `BatchPipeline` sets the
width when it is built, so a test that samples outside a pipeline and
compares the two packages' draws pins both libraries to one width first:
an earlier test in the same worker process may have left either at any
width."""


def same_sampler_width(threads=2):
    """Set both packages' native samplers to ``threads`` OpenMP threads
    (where the library loads)."""
    from gnn_tpu import native as jnative
    port_sampler_width(threads)
    lib = jnative.get_lib()
    if lib is not None:
        lib.set_threads(threads)


def port_sampler_width(threads=2):
    """Set the port's native sampler alone to ``threads`` OpenMP threads
    (where the library loads): for tests that run without the JAX
    package, whose draws would otherwise follow the machine's core
    count."""
    from gnn_tpu_torch import native as tnative
    lib = tnative.get_lib()
    if lib is not None:
        lib.set_threads(threads)
