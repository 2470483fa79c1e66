"""ome-agent CLI — the swiss-army-knife binary.

Re-designs cmd/ome-agent (main.go:27-35 cobra subcommands): argparse
subcommands over the same capabilities — `enigma` encrypt/decrypt,
`replica`, `serving-agent`, `model-metadata`, `hf-download`.
Run as `python -m ome_tpu_torch.agent <subcommand>`.

Port of ome_tpu/agent/cli.py: the same names, formats and behaviour;
it imports nothing of ome_tpu.
"""

from __future__ import annotations

import argparse
import json
import logging
import sys
import time


def _cmd_enigma(args) -> int:
    from .cloudkms import open_kms
    from .enigma import decrypt_dir, encrypt_dir
    if not args.kms and not args.keyfile:
        print("enigma: one of --kms or --keyfile is required",
              file=sys.stderr)
        return 2
    spec = args.kms or f"local:{args.keyfile}"
    kms = open_kms(spec, create=args.mode == "encrypt")
    if args.mode == "encrypt":
        n = encrypt_dir(args.input, args.output, kms)
    else:
        n = decrypt_dir(args.input, args.output, kms)
    print(json.dumps({"mode": args.mode, "files": n,
                      "output": args.output}))
    return 0


def _cmd_replica(args) -> int:
    from ..storage.hub import HubClient
    from .replica import Replicator
    hub = HubClient(endpoint=args.hf_endpoint) if args.hf_endpoint \
        else HubClient()
    rep = Replicator(hub=hub, pvc_mount_root=args.pvc_mount_root,
                     workers=args.workers)
    res = rep.replicate(args.source, args.target)
    print(json.dumps({"source": res.source, "target": res.target,
                      "files": res.files, "bytes": res.bytes}))
    return 0


def _cmd_serving_agent(args) -> int:
    from .serving_agent import ServingAgent
    agent = ServingAgent(args.info_file, args.adapters_dir,
                         poll_interval=args.poll_interval,
                         engine_url=args.engine_url)
    if args.once:
        agent.sync()
        return 0
    agent.start()
    try:
        while True:
            time.sleep(60)
    except KeyboardInterrupt:
        agent.stop()
    return 0


def _cmd_model_metadata(args) -> int:
    from .metadata import publish_metadata
    meta = publish_metadata(args.model_dir, args.out_file)
    print(json.dumps(meta, indent=2))
    return 0 if "error" not in meta else 1


def _cmd_hf_download(args) -> int:
    from ..storage.hub import HubClient
    hub = HubClient(endpoint=args.endpoint) if args.endpoint \
        else HubClient()
    files = hub.snapshot_download(args.repo_id, args.target_dir,
                                  revision=args.revision,
                                  workers=args.workers)
    print(json.dumps({"repo": args.repo_id, "files": len(files)}))
    return 0


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="ome-agent",
        description="model lifecycle agent (enigma/replica/"
                    "serving-agent/model-metadata/hf-download)")
    p.add_argument("-v", "--verbose", action="store_true")
    sub = p.add_subparsers(dest="command", required=True)

    e = sub.add_parser("enigma", help="encrypt/decrypt model weights")
    e.add_argument("mode", choices=["encrypt", "decrypt"])
    e.add_argument("--input", required=True)
    e.add_argument("--output", required=True)
    e.add_argument("--keyfile", help="shorthand for --kms local:<file>")
    e.add_argument("--kms", default=None,
                   help="KMS spec: local:<keyfile> | gcpkms:<key name>")
    e.set_defaults(fn=_cmd_enigma)

    r = sub.add_parser("replica", help="replicate a model between stores")
    r.add_argument("--source", required=True, help="source storage uri")
    r.add_argument("--target", required=True, help="target storage uri")
    r.add_argument("--pvc-mount-root", default="/mnt/pvc")
    r.add_argument("--workers", type=int, default=4)
    r.add_argument("--hf-endpoint", default="")
    r.set_defaults(fn=_cmd_replica)

    s = sub.add_parser("serving-agent",
                       help="fine-tuned-adapter sidecar")
    s.add_argument("--info-file", required=True)
    s.add_argument("--adapters-dir", required=True)
    s.add_argument("--poll-interval", type=float, default=2.0)
    s.add_argument("--engine-url", default=None,
                   help="co-located engine base URL; staged adapters "
                        "hot-load via POST /v1/adapters (multi-LoRA)")
    s.add_argument("--once", action="store_true",
                   help="sync once and exit")
    s.set_defaults(fn=_cmd_serving_agent)

    m = sub.add_parser("model-metadata",
                       help="extract model metadata to JSON")
    m.add_argument("--model-dir", required=True)
    m.add_argument("--out-file", default=None)
    m.set_defaults(fn=_cmd_model_metadata)

    h = sub.add_parser("hf-download", help="snapshot-download a repo")
    h.add_argument("--repo-id", required=True)
    h.add_argument("--target-dir", required=True)
    h.add_argument("--revision", default="main")
    h.add_argument("--workers", type=int, default=4)
    h.add_argument("--endpoint", default="")
    h.set_defaults(fn=_cmd_hf_download)
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    logging.basicConfig(
        level=logging.DEBUG if args.verbose else logging.INFO,
        format="%(asctime)s %(name)s %(levelname)s %(message)s")
    try:
        return args.fn(args)
    except Exception as e:  # noqa: BLE001 — CLI surface
        print(f"error: {e}", file=sys.stderr)
        return 1


if __name__ == "__main__":
    sys.exit(main())
