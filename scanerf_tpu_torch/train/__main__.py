"""Training CLI of the port:

    python -m scanerf_tpu_torch.train config/[SCENE].yaml [--device cpu]

Trains every tile of the config's TILES with the port's ``Trainer`` (ADMM
consensus when RHO > 0) and writes ``training.log``, ``admm_error.txt``,
the ``tile-*`` exports and ``refined_camera.log`` under
DATADIR/logs/. It runs on the GPU and raises without CUDA; ``--device
cpu`` runs the plain PyTorch path.
"""

import argparse


def main(argv=None):
    parser = argparse.ArgumentParser(
        prog="python -m scanerf_tpu_torch.train",
        description="Train a scene's tiles with the PyTorch/CUDA port.")
    parser.add_argument("config", help="scene yaml (overlaid on its SCENE base config)")
    parser.add_argument("--device", default="cuda",
                        help="'cuda' (the default) or 'cpu' for the plain path")
    args = parser.parse_args(argv)
    from scanerf_tpu_torch.config import parse_yaml
    from scanerf_tpu_torch.train.trainer import Trainer

    Trainer(parse_yaml(args.config), device=args.device).run()


if __name__ == "__main__":
    main()
