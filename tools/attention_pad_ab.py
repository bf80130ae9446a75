"""A pooled decode step's device time a rank on the (1, 2) mesh, for each
source tree given, in the order given (e.g. parent, change, change,
parent): phase 37a's llama3-8b at ``TP_LAYERS`` layers, 37e's
grok-1-314b and 37f's llama4-scout-17b-a16e at ``MOE_LAYERS`` (EP), each
served through the tree's own ``chip_smoke._sharded_serve`` on two gloo
ranks sharing the card, then one decode step of 4 slots profiled.  Each
tree runs in a process of its own, with its own package and kernel
build.  Reads what attending over the whole head count on a model axis
(``transformer._heads_whole``) costs against a tree without it.  Details
go to ``chiprun_out/attention_pad_ab.json``.

    python3 tools/attention_pad_ab.py TREE [TREE ...]
"""
import json
import os
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve()
TREE = os.environ.get("AB_TREE")
if TREE:
    sys.path[:0] = [TREE, os.path.join(TREE, "src")]

# (key, arch, layers, engine and trace: None for phase 5's, else chip_smoke's
# MOE_ENGINE / DENSE_TRACE)
TP_LAYERS, MOE_LAYERS = 4, 2
CELLS = (("a", "llama3-8b", TP_LAYERS, False),
         ("e", "grok-1-314b", MOE_LAYERS, True),
         ("f", "llama4-scout-17b-a16e", MOE_LAYERS, True))
KEEP = ("decode_step_device_ms", "decode_step_k1_ms", "decode_step_wall_ms",
        "decode_step_collective_calls", "decode_step_collective_share", "tokens_per_s",
        "peak_gib")


def _rank(rank):
    import torch

    import chip_smoke as cs
    from repro_torch.device import resolve_device
    from repro_torch.kernels import potq_matmul as K

    dev = resolve_device(torch.device("cuda", torch.cuda.current_device()))
    K.build()
    out = {}
    for key, arch, layers, moe in CELLS:
        engine, trace = (cs.MOE_ENGINE, cs.DENSE_TRACE) if moe else (None, None)
        _, row = cs._sharded_serve(rank, dev, (1, 2), layers, None, arch, engine, trace)
        out[key] = {k: row[k] for k in KEEP}
    return out


def _child():
    from repro_torch.kernels import _build, potq_matmul as K
    from repro_torch.parallel import collectives

    t0 = time.perf_counter()
    _build.compile_all([K.SOURCE])
    build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    ranks = collectives.spawn(_rank, 2, device="cuda")
    print("RESULT " + json.dumps(dict(tree=TREE, build_s=build_s,
                                      spawn_s=time.perf_counter() - t0, ranks=ranks)))


def main(trees):
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(card, flush=True)
    runs = []
    for tree in trees:
        env = dict(os.environ, AB_TREE=str(Path(tree).resolve()))
        proc = subprocess.run([sys.executable, str(HERE), "--child"], env=env,
                              capture_output=True, text=True)
        if proc.returncode:
            sys.stderr.write(proc.stdout[-4000:] + proc.stderr[-8000:])
            raise SystemExit(f"{tree}: exit {proc.returncode}")
        res = json.loads([ln for ln in proc.stdout.splitlines()
                          if ln.startswith("RESULT ")][-1][len("RESULT "):])
        runs.append(res)
        for key, arch, *_ in CELLS:
            rows = [r[key] for r in res["ranks"]]
            print(f"{tree} 37{key} {arch}: decode step device ms a rank "
                  f"{[round(r['decode_step_device_ms'], 3) for r in rows]}, K1 "
                  f"{[round(r['decode_step_k1_ms'], 3) for r in rows]}, wall ms "
                  f"{[round(w, 2) for w in rows[0]['decode_step_wall_ms']]} (collectives "
                  f"{rows[0]['decode_step_collective_share']:.2f} of the last), tokens/s "
                  f"{rows[0]['tokens_per_s']:.2f}", flush=True)
    out = HERE.parents[1] / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "attention_pad_ab.json").write_text(json.dumps(dict(card=card, runs=runs), indent=1))
    print("AB OK")


if __name__ == "__main__":
    if sys.argv[1:] == ["--child"]:
        _child()
    else:
        main(sys.argv[1:])
