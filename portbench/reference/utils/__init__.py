"""utils of the PyTorch/CUDA port (counterpart of ``eftpipe_tpu/utils/``)."""
