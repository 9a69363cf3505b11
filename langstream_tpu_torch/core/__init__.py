"""Cross-cutting pieces of the port that every layer may import (stdlib
only): request tracing and the Prometheus metrics reporter; and the
application core, a copy of ``langstream_tpu/core``: YAML (the port's own
loader) to :class:`~langstream_tpu_torch.api.application.Application`
(``parser``), placeholder resolution, the expression language and
templates, the planner with fusion, and the deployer."""
