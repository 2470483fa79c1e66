"""ome.io API types (port of ome_tpu/apis/)."""
