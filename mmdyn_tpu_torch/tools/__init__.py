"""The evaluation, serving-bench and data tools on the port, one module per
tool of the JAX package's ``tools/`` with the same file name, flags and
output schema: ``rollout_eval``, ``counterfactual``, ``accuracy_suite``,
``bench_infer``, ``bench_http``, ``rerender_dataset``, ``bullet_diff`` and
``elbo_parity`` (with its reference-semantics golden model, ``gold``).

    python -m mmdyn_tpu_torch.tools.<name> ... [--platform cpu]

Each runs on the CUDA card; ``--platform cpu`` selects the CPU, and without
a card any other value raises. Each ``main(argv=None)`` returns its report.
``cv2``, ``PIL`` and ``matplotlib`` are imported where they are used.
"""
