"""Does the card's SVD give the same bits for the same input?

Captures the operand of every ``torch.linalg.svd`` call of one batched
Newton step (``parallel.fused_mesh.tt_newton_step_batch`` on the first
Newton systems of the first ``--seeds`` seeds of
configs/maxcut_<dim>.yaml, R = 16, R_eig = 8, nswp = 12, seed 5: the
settings of ``chip_smoke.py``'s phase 10) and then, for each driver
(``default`` = torch's choice, ``gesvd``, ``gesvdj``, ``gesvda``) and each
distinct captured shape, checks:

* repeat: five calls on the same tensor give the same bits;
* batch: an instance factored alone (2-D and as a batch of one) and inside
  its captured batch, and inside a batch of three copies, gives the same
  bits;
* process: the factors' digest agrees between two fresh processes
  (``--digest`` children, run by the parent);
* time: the median ms of one call at that shape (CUDA events).

    python -m ttipm_tpu_torch.tools.svd_repeat [--dim 10 --seeds 2]
    python -m ttipm_tpu_torch.tools.svd_repeat --dim 3 --device cpu   # the plain run

Prints one JSON line a (driver, shape) and a last summary line; the
captured operands go to a temporary file that the children read.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

DRIVERS = ("default", "gesvd", "gesvdj", "gesvda")
STEP = {"R": 16, "R_eig": 8, "nswp": 12, "seed": 5}
PER_SHAPE = 3  # operands kept per distinct shape


def _svd(a, driver):
    kw = {} if driver == "default" or a.device.type == "cpu" else {"driver": driver}
    return torch.linalg.svd(a, full_matrices=False, **kw)


def _bits(out):
    return [t.detach().cpu().numpy().tobytes() for t in out]


def capture(dim: int, seeds: int, device) -> dict:
    """{shape: [operand, ...]} of the SVDs of one batched Newton step."""
    from ttipm_tpu_torch.checks import first_newton_system
    from ttipm_tpu_torch.parallel.fused_mesh import tt_newton_step_batch
    from ttipm_tpu_torch.utils.runner import load_yaml

    repo = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    cfg = load_yaml(os.path.join(repo, "configs", f"maxcut_{dim}.yaml"))
    inst = [first_newton_system("maxcut", cfg, int(s), device) for s in cfg["seeds"][:seeds]]
    seen: dict = {}
    orig = torch.linalg.svd

    def recording(a, *args, **kw):
        key = tuple(a.shape)
        if a.dtype == torch.float64 and len(seen.setdefault(key, [])) < PER_SHAPE:
            seen[key].append(a.detach().clone())
        return orig(a, *args, **kw)

    np.random.seed(STEP["seed"])
    torch.linalg.svd = recording
    try:
        tt_newton_step_batch([i[:2] for i in inst], [i[2] for i in inst], [i[3] for i in inst],
                             **STEP)
    finally:
        torch.linalg.svd = orig
    return seen


def _median_ms(fn, device, runs=10):
    for _ in range(3):
        fn()
    times = []
    for _ in range(runs):
        if device.type == "cuda":
            start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            stop.record()
            stop.synchronize()
            times.append(start.elapsed_time(stop))
        else:
            t0 = time.perf_counter()
            fn()
            times.append(1e3 * (time.perf_counter() - t0))
    return float(np.median(times))


def check(a, driver) -> dict:
    """Repeat and batch checks of one operand (2-D, or a (B, m, n) batch)."""
    try:
        first = _bits(_svd(a, driver))
    except RuntimeError as exc:  # a driver the build or the shape does not take
        return {"error": str(exc).splitlines()[0][:160]}
    repeat = all(_bits(_svd(a, driver)) == first for _ in range(4))
    mats = a if a.dim() == 3 else a[None]
    batch = True
    for i in range(mats.shape[0]):
        alone = _bits(_svd(mats[i], driver))
        one = _bits(_svd(mats[i:i + 1], driver))
        in_batch = [t[i].detach().cpu().numpy().tobytes() for t in _svd(mats, driver)]
        three = [t[1].detach().cpu().numpy().tobytes()
                 for t in _svd(torch.stack([mats[i - 1], mats[i], mats[(i + 1) % len(mats)]]),
                               driver)]
        batch = batch and alone == one == in_batch == three
    u, s, vt = _svd(a, driver)
    err = float(((u * s[..., None, :]) @ vt - a).abs().max() / a.abs().max().clamp_min(1e-300))
    return {"repeat": repeat, "batch": batch, "rel_reconstruction": err,
            "ms": _median_ms(lambda: _svd(a, driver), a.device)}


def digests(operands: dict, device) -> dict:
    out = {}
    for key, mats in operands.items():
        for j, m in enumerate(mats):
            a = torch.as_tensor(m, device=device)
            for driver in DRIVERS:
                try:
                    bits = _bits(_svd(a, driver))
                except RuntimeError:
                    continue
                out[f"{key}/{j}/{driver}"] = hashlib.sha256(b"".join(bits)).hexdigest()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--dim", type=int, default=10)
    ap.add_argument("--seeds", type=int, default=2)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--digest", nargs=2, metavar=("OPERANDS", "OUT"),
                    help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("svd_repeat: no CUDA device (pass --device cpu for the plain run)")
    if args.digest:
        with np.load(args.digest[0]) as f:
            operands = {}
            for name in f.files:
                key, _ = name.rsplit("_", 1)
                operands.setdefault(key, []).append(f[name])
        with open(args.digest[1], "w") as fh:
            json.dump(digests(operands, device), fh)
        return 0

    t0 = time.perf_counter()
    seen = capture(args.dim, args.seeds, device)
    summary = {d: {"repeat": True, "batch": True, "process": True, "ms": 0.0} for d in DRIVERS}
    for key, mats in sorted(seen.items()):
        for driver in DRIVERS:
            rows = [check(m, driver) for m in mats]
            if any("error" in r for r in rows):
                summary[driver]["error"] = next(r["error"] for r in rows if "error" in r)
                print(json.dumps({"driver": driver, "shape": key, **rows[0]}), flush=True)
                continue
            row = {"driver": driver, "shape": key, "operands": len(mats),
                   "repeat": all(r["repeat"] for r in rows), "batch": all(r["batch"] for r in rows),
                   "rel_reconstruction": max(r["rel_reconstruction"] for r in rows),
                   "ms": float(np.median([r["ms"] for r in rows]))}
            summary[driver]["repeat"] &= row["repeat"]
            summary[driver]["batch"] &= row["batch"]
            summary[driver]["ms"] += row["ms"]
            print(json.dumps(row), flush=True)

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "operands.npz")
        np.savez(path, **{f"{k}_{j}": m.cpu().numpy() for k, mats in seen.items()
                          for j, m in enumerate(mats)})
        runs = []
        for n in range(2):
            out = os.path.join(tmp, f"digest{n}.json")
            subprocess.run([sys.executable, "-m", "ttipm_tpu_torch.tools.svd_repeat",
                            "--device", args.device, "--digest", path, out], check=True,
                           cwd=os.path.dirname(os.path.dirname(os.path.dirname(
                               os.path.abspath(__file__)))))
            with open(out) as fh:
                runs.append(json.load(fh))
    here = digests({k: [m.cpu().numpy() for m in v] for k, v in seen.items()}, device)
    for name, digest in here.items():
        driver = name.rsplit("/", 1)[1]
        if not (digest == runs[0].get(name) == runs[1].get(name)):
            summary[driver]["process"] = False
    print(json.dumps({"svd_repeat": summary, "shapes": len(seen),
                      "device": torch.cuda.get_device_name(0) if device.type == "cuda" else "cpu",
                      "wall_s": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
