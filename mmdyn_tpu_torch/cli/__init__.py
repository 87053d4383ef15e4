"""Command-line entry points: training (``main``) and offline evaluation
(``evaluate``)."""
