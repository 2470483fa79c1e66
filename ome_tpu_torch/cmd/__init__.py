"""Command-line helpers of the port (port of ome_tpu/cmd/, only what the
router reaches: `manager.build_client`)."""
