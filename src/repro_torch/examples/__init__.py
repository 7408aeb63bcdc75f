"""Runnable examples of the port: ``python -m repro_torch.examples.<name>``
(quickstart, serve_gcn, hybrid_spmm_demo); each runs on the card unless
``--device cpu``."""
