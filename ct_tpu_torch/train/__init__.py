"""Training: solver, train step, OBJ_Target init, checkpoints, sampler, and
the CLI (``python -m ct_tpu_torch.train``, in ``cli.py``)."""
