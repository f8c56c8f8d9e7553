"""Drives of the main path at full size: ``churn`` (add / remove on a live
IVF index) and ``serve_load`` (the HTTP daemon under concurrent load). Each
runs as ``python -m text_similarity_tpu_torch.drives.<name>`` and prints one
JSON line a phase."""
