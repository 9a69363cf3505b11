"""The port's command line: ``python -m langstream_tpu_torch.cli <command>``
— the JAX CLI's admin commands (``configure``, ``tenants``, ``apps``,
``archetypes``, ``gateway``, ``docs``) over the port's admin client, and
``run``, the dev mode that serves the control plane, the gateway and the
application through the port (see :mod:`langstream_tpu_torch.cli.main`)."""
