"""Training CLI of the port:

    python -m scanerf_tpu_torch.train config/[SCENE].yaml [--device cpu]
    torchrun --nproc-per-node N -m scanerf_tpu_torch.train config/[SCENE].yaml
        [--backend gloo]

Trains every tile of the config's TILES with the port's ``Trainer`` (ADMM
consensus when RHO > 0) and writes ``training.log``, ``admm_error.txt``,
the ``tile-*`` exports and ``refined_camera.log`` under
DATADIR/logs/. It runs on the GPU and raises without CUDA; ``--device
cpu`` runs the plain PyTorch path. Under ``torchrun`` the ranks join one
process group with the collective ``--backend`` (``nccl``, the default,
for a card a rank; ``gloo`` for the CPU or for ranks that share a card),
and the tiles, TABLE_SHARDS and RAY_SHARDS spread over them
(``Trainer``); each rank takes card LOCAL_RANK modulo the cards.
"""

import argparse


def main(argv=None):
    parser = argparse.ArgumentParser(
        prog="python -m scanerf_tpu_torch.train",
        description="Train a scene's tiles with the PyTorch/CUDA port.")
    parser.add_argument("config", help="scene yaml (overlaid on its SCENE base config)")
    parser.add_argument("--device", default="cuda",
                        help="'cuda' (the default) or 'cpu' for the plain path")
    parser.add_argument("--backend", default="nccl",
                        help="collective backend of a multi-rank run: 'nccl' (the default, "
                             "a card a rank) or 'gloo' (the CPU, or ranks sharing a card)")
    args = parser.parse_args(argv)
    from scanerf_tpu_torch.config import parse_yaml
    from scanerf_tpu_torch.parallel import mesh as mesh_lib
    from scanerf_tpu_torch.train.trainer import Trainer

    _, world = mesh_lib.init_ranks(args.backend)
    if world > 1 and args.backend == "nccl":
        import torch

        torch.cuda.set_device(mesh_lib.local_device(args.device))
    Trainer(parse_yaml(args.config), device=args.device).run()


if __name__ == "__main__":
    main()
