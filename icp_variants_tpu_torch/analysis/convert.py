"""Whitespace-separated text -> CSV converter (Data/convert.py equivalent,
Data/convert.py:1-27): used to turn benchmark pose lists into loader CSVs.

    python -m icp_variants_tpu_torch.analysis.convert input.txt output.csv
"""

from __future__ import annotations

import sys


def convert(in_path: str, out_path: str) -> None:
    with open(in_path) as fin, open(out_path, "w") as fout:
        for line in fin:
            parts = line.split()
            if parts:
                fout.write(",".join(parts) + "\n")


def main(argv: list[str] | None = None) -> int:
    argv = argv if argv is not None else sys.argv[1:]
    if len(argv) != 2:
        print("usage: convert <input.txt> <output.csv>", file=sys.stderr)
        return 2
    convert(argv[0], argv[1])
    return 0


if __name__ == "__main__":
    sys.exit(main())
