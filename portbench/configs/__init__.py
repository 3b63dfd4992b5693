"""The port's side of each configuration: builds its modules, state, step
and loader through the trainer's public functions (``configs/<config>.py``),
beside the sizes as they are run (``configs/<config>.json``)."""
