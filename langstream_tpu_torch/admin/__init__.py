"""The port's admin client (a copy of ``langstream_tpu/admin``)."""

from langstream_tpu_torch.admin.client import AdminApiError, AdminClient

__all__ = ["AdminClient", "AdminApiError"]
