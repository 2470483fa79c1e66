"""`python -m ome_tpu_torch.agent` (port of ome_tpu/agent/__main__.py)."""

from .cli import main

if __name__ == "__main__":
    raise SystemExit(main())
