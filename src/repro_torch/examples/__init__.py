"""Runnable examples of the port, the torch counterparts of the
repository's ``examples/``: ``python -m repro_torch.examples.<name>``
(``quickstart``, ``serve_decode``, ``modelcheck_demo``,
``elastic_train``). Each does its work under ``__main__`` only, so
importing one runs nothing."""
