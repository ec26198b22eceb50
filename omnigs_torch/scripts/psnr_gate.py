"""PSNR bar check of the quality gate (`omnigs_torch/scripts/quality_check.sh`).

The port's copy of `scripts/psnr_gate.py`, so that the gate needs nothing
outside the package.

    python -m omnigs_torch.scripts.psnr_gate BAR RESULT_DIR [RESULT_DIR...]

Reads each RESULT_DIR/psnr_test.txt ("<view> <psnr>" lines) and exits 0
iff the MEDIAN of the per-run mean PSNRs is >= BAR: gating the median of
independent-seed runs halves the single-run noise.
"""

import pathlib
import statistics
import sys


def main(bar: float, result_dirs) -> int:
    means = []
    for rd in result_dirs:
        vals = [
            float(line.split()[1])
            for line in (pathlib.Path(rd) / "psnr_test.txt").read_text().splitlines()
            if line.strip()
        ]
        means.append(sum(vals) / len(vals))
    med = statistics.median(means)
    ok = med >= bar
    runs = ", ".join(f"{m:.2f}" for m in means)
    print(
        f"[quality_check] held-out PSNR median {med:.2f} (runs: {runs}) "
        f"vs bar {bar:.2f} ({'OK' if ok else 'FAIL'})"
    )
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main(float(sys.argv[1]), sys.argv[2:]))
