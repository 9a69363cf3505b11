"""The pod's slice seam of the port (see :mod:`langstream_tpu_torch.runtime.pod`)."""
