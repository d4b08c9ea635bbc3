"""Command line of the port. This slice has the ``serve`` subcommand:

    python -m soft_contrastive_learning_torch.cli serve \
        --checkpoint soft_contrastive_learning_tpu/assets/flagship_trained.npz \
        --index features.pickle

Flags follow ``scl-tpu serve`` (``soft_contrastive_learning_tpu/cli.py``),
without ``--quant_scales`` (the int8 path is a later slice) and with
``--device`` (default ``cuda``). ``--checkpoint`` takes a flagship-layout
npz; it defaults to the committed trained artifact.
"""

from __future__ import annotations

import argparse
import sys
from typing import Optional, Sequence

import numpy as np


def cmd_serve(args) -> int:
    from soft_contrastive_learning_torch.core.config import ModelConfig
    from soft_contrastive_learning_torch.models.weights import load_trained_params
    from soft_contrastive_learning_torch.serving import DescriptorService, serve
    from soft_contrastive_learning_torch.utils.io import load_pickle

    cfg = ModelConfig(vlad_cores=args.vlad_cores, reduction=args.reduction,
                      out_dim=args.out_dim)
    params = load_trained_params(args.checkpoint or None, cfg)
    index = np.asarray(load_pickle(args.index)) if args.index else None
    service = DescriptorService(cfg, params, batch_size=args.batch_size, index=index,
                                device=args.device)
    server = serve(service, host=args.host, port=args.port)
    print(f"serving on http://{args.host}:{server.server_address[1]}")
    try:
        server.serve_forever()
    finally:
        server.server_close()
    return 0


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(prog="soft_contrastive_learning_torch.cli")
    sub = parser.add_subparsers(dest="command", required=True)
    p = sub.add_parser("serve", help="HTTP descriptor-embedding service")
    p.add_argument("--checkpoint", default="",
                   help="flagship-layout params npz (default: the committed trained artifact)")
    p.add_argument("--index", default="", help="feature pickle to serve /search from")
    p.add_argument("--vlad_cores", type=int, default=64)
    p.add_argument("--reduction", default="none")
    p.add_argument("--out_dim", type=int, default=512)
    p.add_argument("--batch_size", type=int, default=16)
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8377)
    p.add_argument("--device", default="cuda", help="torch device; 'cpu' only when asked")
    p.set_defaults(func=cmd_serve)
    return parser


def main(argv: Optional[Sequence[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    return args.func(args)


if __name__ == "__main__":
    sys.exit(main())
