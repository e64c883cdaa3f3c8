"""The example runners of examples/*.py on the port: each module's
`build(scale, device)` gives the example's MpmData at that SCALE, and

    python -m wgsparkl_tpu_torch.examples.<name>

runs it through the port's Testbed, on the card unless DEVICE=cpu, with the
example's environment variables (SCALE, FRAMES, TRANSFER, GROUP, BY for the
dam break, PLY_EVERY, DUMP_DIR)."""
