"""Deployment and serving (port of ``mmdyn_tpu/serve``): forward-only
sessions, the fixed-batch predictor as a CUDA graph, portable
``torch.export`` artifacts, and the HTTP server (``serve/server.py``)."""

from mmdyn_tpu_torch.serve.export import export_session, load_exported
from mmdyn_tpu_torch.serve.session import InferenceSession

__all__ = ["InferenceSession", "export_session", "load_exported"]
