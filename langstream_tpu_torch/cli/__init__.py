"""The port's command line: ``python -m langstream_tpu_torch.cli run ...``,
the dev mode that parses, plans and runs an application through the port
and serves its gateways (see :mod:`langstream_tpu_torch.cli.main`)."""
