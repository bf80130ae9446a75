"""Phases 30 and 37 of ``chip_smoke.py`` alone, on one GPU, for the
reading behind phase 30's depth cut: build the kernels, serve
whisper-large-v3 through phase 30 at all 32 decoder layers and at
``ENCDEC_LAYERS`` (each timed), serve grok-1-314b through phase 27 (its
tokens are 37e's gate) and llama3-8b through phase 5's engine (37a's),
then run phase 37 (a-g, ``chip_smoke.multi_gpu``) and print every
phase's seconds.  Details go to ``chiprun_out/p37e.json``.

    python3 tools/phase37_moe_probe.py
"""
import dataclasses
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
    from repro_torch import configs
    from repro_torch.core.policy import PAPER_FAITHFUL
    from repro_torch.device import resolve_device
    from repro_torch.kernels import _build, potq_encode as KE, potq_grad as KG
    from repro_torch.kernels import potq_matmul as K
    from repro_torch.models import registry, spec
    from repro_torch.serve import PoolEngine
    from repro_torch.serve import quantized_weights as qw

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    print("torch", torch.__version__, torch.version.cuda, flush=True)
    dev = resolve_device("cuda")
    t0 = time.perf_counter()
    _build.compile_all([K.SOURCE, KG.SOURCE, KE.SOURCE])
    K.build()
    KG.build()
    KE.build()
    print("build", time.perf_counter() - t0, flush=True)
    detail, times = {}, {}
    for n in (None, cs.ENCDEC_LAYERS):
        t0 = time.perf_counter()
        cs.dense_serving(dev, detail, cs.ENCDEC_ARCH, 30, n_layers=n, max_len=64,
                         trace=cs.ENCDEC_TRACE)
        times[f"phase30_{n or 32}_layers"] = time.perf_counter() - t0
        print("TIME", times, flush=True)
    t0 = time.perf_counter()
    cs.dense_serving(dev, detail, "grok-1-314b", 27, n_layers=cs.MOE_ARCHS["grok-1-314b"])
    times["phase27"] = time.perf_counter() - t0
    cs.phase("5 (its tokens only)")
    cfg = configs.get_config("llama3-8b")
    params = spec.materialize(registry.param_specs(cfg),
                              torch.Generator(device=dev).manual_seed(0),
                              transform=lambda n, x: qw.quantize_leaf(n, x, PAPER_FAITHFUL))
    pol = dataclasses.replace(PAPER_FAITHFUL, weights_prequantized=True)
    eng = PoolEngine(cfg, pol, params, max_slots=4, max_len=160, device=dev)
    toks = {str(u): t.tolist() for u, t in eng.run(cs._serve_trace(cfg)).items()}
    del params, eng
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    try:
        cs.multi_gpu(dev, detail, toks)
    finally:
        times["phase37"] = time.perf_counter() - t0
        print("TIME", times, flush=True)
        (ROOT / "chiprun_out").mkdir(exist_ok=True)
        (ROOT / "chiprun_out" / "p37e.json").write_text(json.dumps(detail, indent=1,
                                                                   default=str))
    print("PROBE OK")


if __name__ == "__main__":
    main()
