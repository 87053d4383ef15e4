"""The evaluation, serving-bench and data tools on the port, one module per
tool of the JAX package's ``tools/`` with the same file name, flags and
output schema: ``rollout_eval``, ``counterfactual``, ``accuracy_suite``,
``bench_infer``, ``bench_http``, ``rerender_dataset``, ``bullet_diff``,
``elbo_parity`` (with its reference-semantics golden model, ``gold``),
``multihost_smoke`` and ``plot_run``.

    python -m mmdyn_tpu_torch.tools.<name> ... [--platform cpu]

Each runs on the CUDA card; ``--platform cpu`` selects the CPU, and without
a card any other value raises. ``plot_run`` reads a run's metrics on the
host and has no ``--platform``. Each ``main(argv=None)`` returns its report.
``cv2``, ``PIL`` and ``matplotlib`` are imported where they are used.
"""
