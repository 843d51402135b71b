"""The port's runtime checks and post-mortem reader: ``lockcheck`` (the
KTPU_LOCK_CHECK lock-order checker every host module takes its locks
through) and ``python -m kubernetes_tpu_torch.analysis --flight``."""
