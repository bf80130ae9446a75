"""Phases 19-27 and 29-30 of ``chip_smoke.py`` alone, on one GPU: build
K1, then serve llama3-8b at full width through the chunked + paged
engine, the prefix cache, PoT-quantized KV pages, speculative decoding,
lockstep serving and float32 pages, then mistral-nemo-12b and
starcoder2-7b at full width, llama4-scout-17b-a16e and grok-1-314b at
full width and cut depth, and internvl2-76b (16 of 80 layers) and
whisper-large-v3 at full width, with every gate of those phases.

    python3 tools/serving_smoke.py

Details go to chiprun_out/serving.json.  Exits non-zero without a CUDA
device or when a gate fails.
"""
import json
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))


def main() -> int:
    if not torch.cuda.is_available():
        print("serving_smoke: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke
    from repro_torch.device import resolve_device
    from repro_torch.kernels import _build
    from repro_torch.kernels import potq_matmul as K

    dev = resolve_device("cuda")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    t0 = time.perf_counter()
    print("nvcc", _build.compile_all([K.SOURCE]))
    K.build()
    detail = {}
    print(chip_smoke.serving(dev, detail))
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "serving.json").write_text(json.dumps(detail, indent=1))
    print(f"took {time.perf_counter() - t0:.1f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
