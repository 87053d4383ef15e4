"""Command-line entry points: training (``main``), offline evaluation
(``evaluate``), serving (``infer``, ``serve``) and synthetic data
(``make_synthetic``)."""
