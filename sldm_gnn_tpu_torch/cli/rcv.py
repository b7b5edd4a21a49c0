"""Streaming inference CLI (argparse twin of ``sldm_gnn_tpu/cli/rcv.py``).

    python -m sldm_gnn_tpu_torch.cli.rcv -f frames.fifo -p 100 -s snap.pkl \\
        [-O out.csv] [--m-radius 25.0] [--device cuda]

Serves the incremental path (one O(V²) graph update per frame), whose
scores equal the full per-window rebuild's.
"""

from __future__ import annotations

import argparse
from pathlib import Path

from ..serve.stream import StreamingServer


def _existing_file(s: str) -> Path:
    p = Path(s)
    if not p.exists() or p.is_dir():
        raise argparse.ArgumentTypeError(f"{s} does not exist or is a directory")
    return p


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="rcv", description=__doc__.split("\n")[0])
    ap.add_argument("-f", "--fifo-path", required=True, type=_existing_file,
                    help="FIFO (named pipe) carrying newline-delimited JSON frames.")
    ap.add_argument("-p", "--pack-size", required=True, type=int,
                    help="Frames per sliding inference window.")
    ap.add_argument("-s", "--snapshot-path", required=True, type=_existing_file)
    ap.add_argument("-O", "--output-csv-file", type=Path, default=Path("out.csv"))
    ap.add_argument("--m-radius", type=float, default=25.0,
                    help="Edge radius for online graph construction.")
    ap.add_argument("--device", default="cuda", help="'cuda' (default) or 'cpu'.")
    return ap


def main(argv: list[str] | None = None) -> None:
    args = build_parser().parse_args(argv)
    server = StreamingServer(
        args.fifo_path, args.snapshot_path, args.output_csv_file,
        pack_size=args.pack_size, m_radius=args.m_radius, device=args.device)
    server.run()
    print("Bye!")


if __name__ == "__main__":
    main()
