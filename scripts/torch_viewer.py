#!/usr/bin/env python3
"""The interactive web viewer on a trained rig, on the PyTorch port (the twin
of scripts/viewer.py; ``--device`` in place of ``--platform``).

    python scripts/torch_viewer.py --model_path out/              # on the card, port 8080
    python scripts/torch_viewer.py --model_path out/ --port 0 --device cpu

Loads what scripts/torch_run_pipeline.py (or scripts/run_pipeline.py)
writes: cfg.json, skeleton_tree.npz, the latest
rig/point_cloud/iteration_*/point_cloud.ply and, when one fits, the latest
rig checkpoint (``torch_render_rig.load_rig``), then serves it
(``viz/web_viewer.py``) until stopped. The reference's template holds one
projection loss, so it never loads the checkpoint of a scene of more than
one training frame and shows the PLY with fresh nets; the twin sizes the
template from the checkpoint.
"""
import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def load_viewer(model_path, device):
    """The ViewerServer of the rig at ``model_path`` on ``device``."""
    from riggs_tpu_torch.device import resolve_device
    from riggs_tpu_torch.train.config import Config
    from riggs_tpu_torch.viz.web_viewer import ViewerServer
    from scripts.torch_render_rig import load_rig

    model_path = Path(model_path)
    dev = resolve_device(device)
    state, _ = load_rig(model_path, Config.load(model_path / "cfg.json"), None, dev)
    return ViewerServer(state.gs, skel=state.skel, device=dev)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--model_path", required=True)
    ap.add_argument("--port", type=int, default=8080)
    ap.add_argument("--device", type=str, default="cuda")
    args = ap.parse_args(argv)
    load_viewer(args.model_path, args.device).serve(port=args.port)


if __name__ == "__main__":
    main()
