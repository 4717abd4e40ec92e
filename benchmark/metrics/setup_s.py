"""setup_s (s, host clock): process start to the first timed unit: imports,
CUDA, the kernels' libraries, the problem, the inputs from the seed, the cold
solve and the warm-up units."""


def read(ctx):
    return ctx["setup_s"]
