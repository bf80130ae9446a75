"""Phases 3 (K1's start variant), 27, 29, 30 and 37 of ``chip_smoke.py``
alone, on one GPU: build the kernels, hold K1's ``start`` variant at the
row-parallel shapes (``START_CASES``), serve grok-1-314b through phase
27, internvl2-76b through phase 29 and whisper-large-v3 through phase 30
(their tokens are 37e's, 37h's and 37i's gates), then run phase 37
(a-k, ``chip_smoke.multi_gpu``) and print every phase's seconds.  Details
go to ``chiprun_out/p37.json``.

    python3 tools/phase37_probe.py
"""
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402


def main():
    from repro_torch.device import resolve_device
    from repro_torch.kernels import _build, potq_encode as KE, potq_grad as KG
    from repro_torch.kernels import potq_matmul as K

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(card)
    print("torch", torch.__version__, torch.version.cuda, flush=True)
    dev = resolve_device("cuda")
    t0 = time.perf_counter()
    _build.compile_all([K.SOURCE, KG.SOURCE, KE.SOURCE])
    K.build()
    KG.build()
    KE.build()
    print("build", time.perf_counter() - t0, flush=True)
    detail, times = {"card": card}, {}
    t0 = time.perf_counter()
    cs.phase("3 K1's start variant")
    detail["k1_start_variant"] = cs.k1_start_checks(
        dev, torch.Generator(device=dev).manual_seed(0))[0]
    times["phase3_start"] = time.perf_counter() - t0
    runs = ((27, "grok-1-314b", dict(n_layers=cs.MOE_ARCHS["grok-1-314b"])),
            (29, cs.VLM_ARCH, dict(n_layers=cs.VLM_LAYERS, max_len=400)),
            (30, cs.ENCDEC_ARCH, dict(n_layers=cs.ENCDEC_LAYERS, max_len=64,
                                      trace=cs.ENCDEC_TRACE)))
    try:
        for number, arch, kw in runs:
            t0 = time.perf_counter()
            cs.dense_serving(dev, detail, arch, number, **kw)
            times[f"phase{number}"] = time.perf_counter() - t0
            print("TIME", times, flush=True)
        t0 = time.perf_counter()
        cs.multi_gpu(dev, detail)
        times["phase37"] = time.perf_counter() - t0
    finally:
        print("TIME", times, flush=True)
        (ROOT / "chiprun_out").mkdir(exist_ok=True)
        (ROOT / "chiprun_out" / "p37.json").write_text(json.dumps(detail, indent=1,
                                                                  default=str))
    print("PROBE OK")


if __name__ == "__main__":
    main()
