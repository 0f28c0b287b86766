"""Migration helpers for users of the upstream (Cobaya-based) eftpipe
(counterpart of ``eftpipe_tpu/compat/``)."""

from .cobaya import convert_cobaya_config

__all__ = ["convert_cobaya_config"]
