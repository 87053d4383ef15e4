"""Device ms a step in elementwise kernels (BatchNorm, swish, Adam and the
rest of PyTorch's elementwise passes, by name: ``devtrace.kernel_family``)."""

from bench_port.train_readers import family_ms


def read(ctx):
    return family_ms(ctx, "elementwise")
