"""The committed cells at a size the CPU runs in seconds, for the tests."""

import types


def tiny_cell(name, model=None, **mix_overrides):
    """The committed cell ``name`` with its mix cut to a size the CPU runs
    in seconds (widths unchanged), and the keys of ``model`` changed in its
    configuration's model."""
    from bench_port import core

    cell, config, mix, limits, metrics = core.find_cell(name)
    if model:
        config = dict(config, model=dict(config["model"], **model))
    mix = dict(mix, batch=4, steps_per_epoch=3, warm_epochs=1, trace_epochs=1)
    mix.update(mix_overrides)
    return cell, config, mix, limits, metrics


def run_tiny(name, seed=2**31 + 7, trace=0, fault=None, control=None, seconds=0.3,
             model=None, **mix_overrides):
    """One run of ``name`` on the CPU at ``tiny_cell``'s size: (result, checks)."""
    import time

    import torch

    from bench_port import core

    torch.set_num_threads(2)
    cell, config, mix, limits, metrics = tiny_cell(name, model, **mix_overrides)
    args = types.SimpleNamespace(seed=seed, seconds=seconds, trace=trace)
    return core.runner(mix)(args, cell, config, mix, limits, metrics, time.monotonic(),
                            device="cpu", fault=fault, control=control)
