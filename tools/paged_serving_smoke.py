"""Phases 19-20 of ``chip_smoke.py`` alone, on one GPU: build K1, then
serve llama3-8b at full width through the chunked + paged engine and the
prefix cache, with every gate of those phases.

    python3 tools/paged_serving_smoke.py

Details go to chiprun_out/paged_serving.json.  Exits non-zero without a
CUDA device or when a gate fails.
"""
import json
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))


def main() -> int:
    if not torch.cuda.is_available():
        print("paged_serving_smoke: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke
    from repro_torch.device import resolve_device
    from repro_torch.kernels import _build
    from repro_torch.kernels import potq_matmul as K

    dev = resolve_device("cuda")
    t0 = time.perf_counter()
    print("nvcc", _build.compile_all([K.SOURCE]))
    K.build()
    detail = {}
    print(chip_smoke.paged_serving(dev, detail))
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "paged_serving.json").write_text(json.dumps(detail, indent=1))
    print(f"took {time.perf_counter() - t0:.1f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
