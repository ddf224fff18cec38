"""Production-mesh dry-run for one (arch x shape) on the PyTorch port (the
twin of ``examples/multipod_dryrun.py``): trace the step as rank 0 of a
fake 512-rank process group on the 2x16x16 multi-pod mesh
(``repro_torch.launch.dryrun``) and print the H100 roofline terms.  No
device allocation: the trace runs on tensors without data, on the CPU
of any host, so ``--device`` defaults to ``cpu`` here (``cuda`` only
checks that a card is present).

    python examples/torch/multipod_dryrun.py [--arch hymba-1.5b --shape train_4k]
"""
import argparse
import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, os.path.join(REPO, "src"))

from repro_torch import resolve_device  # noqa: E402


def main(argv=None) -> dict:
    """-> {"result": the CLI's JSON line (None if it printed none),
    "lines": the printed lines, "returncode"}."""
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", default="hymba-1.5b")
    ap.add_argument("--shape", default="train_4k")
    ap.add_argument("--device", default="cpu",
                    help="cpu (default); the trace needs no card")
    args = ap.parse_args(argv)
    resolve_device(args.device)
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         args.arch, "--shape", args.shape, "--multi-pod"],
        capture_output=True, text=True, env=env, timeout=3600)
    lines, result = [], None

    def say(s):
        print(s, flush=True)
        lines.append(s)
    for line in out.stdout.splitlines():
        if line.startswith("{"):
            r = result = json.loads(line)
            say(f"arch={r['arch']} shape={r['shape']} mesh={r['mesh']} "
                f"ok={r['ok']}")
            if r["ok"]:
                say("  roofline: " + ", ".join(
                    f"{k}={v:.4f}s" for k, v in r["roofline"].items()))
                # the trace's peak live bytes (arguments included) in place
                # of XLA's temp allocation
                say(f"  dominant: {r['dominant']}  "
                    f"peak={r['memory']['peak_bytes']/1e9:.1f} GB/device")
                say(f"  collectives: {r['collectives']}")
    if out.returncode != 0:
        say(out.stderr[-1000:])
    return {"result": result, "lines": lines, "returncode": out.returncode}


if __name__ == "__main__":
    main()
