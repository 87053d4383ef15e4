"""Device ms a step in convolution kernels (cuDNN's forward, data- and
weight-gradient kernels and the FFT path's, by name:
``devtrace.kernel_family``)."""

from bench_port.train_readers import family_ms


def read(ctx):
    return family_ms(ctx, "conv")
