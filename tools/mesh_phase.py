"""chip_smoke.py's mesh phases alone on the card: build the kernels, print
the card, run ``phase_mesh`` (serving, two ranks on cuda:0 over gloo)
and/or ``phase_train_mesh`` (training's data axis, likewise).  From the
repository root, on a machine with a CUDA card:

    python3 tools/mesh_phase.py [mesh] [train_mesh]     # default: both
"""
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]


def main() -> None:
    import torch
    import chip_smoke
    from repro_torch.kernels import _build
    t0 = time.time()
    print("built", _build.build(), flush=True)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(card, torch.__version__, torch.version.cuda, flush=True)
    phases = {"mesh": chip_smoke.phase_mesh,
              "train_mesh": chip_smoke.phase_train_mesh}
    for name in sys.argv[1:] or list(phases):
        t1 = time.time()
        print(name, phases[name](torch.device("cuda"), card), flush=True)
        print(f"{name} seconds {time.time() - t1:.1f}", flush=True)
    print(f"seconds {time.time() - t0:.1f}")


if __name__ == "__main__":   # the mesh ranks re-import this file
    main()
