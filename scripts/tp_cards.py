"""The flagship ``if_glow_mnist`` on a 2 x 2 (data, model) mesh across
four cards of one host, one rank a card over NCCL: ``chip_smoke.py``'s
phase 18 step (:func:`chip_smoke.mesh_flagship`: the coupling nets split
256 + 256 over the model axis, 50 examples a data row, 3 steps, step 1
against the one-process step, the replicas checked after every step) with
its ms/step and all-reduce ms, here on four cards. Run it under torchrun
(``scripts/tp_cards.sh`` builds the chain kernel first and runs it):

    torchrun --standalone --nproc_per_node=4 scripts/tp_cards.py

Rank 0 prints the ``mesh:`` lines and the cards' names and power limits.
"""

import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main():
    import torch
    import torch.distributed as dist

    sys.path.insert(0, ROOT)
    import chip_smoke
    from inverse_flow_tpu_torch import parallel as dp
    from inverse_flow_tpu_torch.ops import _build

    if not torch.cuda.is_available():
        chip_smoke.fail("tp_cards: no CUDA card")
    dev = dp.init_from_env()
    size = chip_smoke.MESH_SHAPE[0] * chip_smoke.MESH_SHAPE[1]
    if dp.world().size != size or dist.get_backend() != "nccl":
        chip_smoke.fail(f"tp_cards: needs a world of {size} over NCCL "
                        f"(torchrun --nproc_per_node={size})")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _build.chain_solve_lib(dev.index)
    smi = subprocess.run(
        ["nvidia-smi", f"--id={dev.index}", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip()
    out = chip_smoke.mesh_flagship(dev, f"[{smi}]")
    ranks = [None] * size
    dist.all_gather_object(ranks, dict(out, card=smi))
    if dist.get_rank() == 0:
        chip_smoke.mesh_summary(ranks, f"NCCL, one rank a card ({size} "
                                f"cards)", f"[{smi}]")
        for rank, r in enumerate(ranks):
            print(f"tp_cards: rank {rank} on [{r['card']}]", flush=True)
    dist.destroy_process_group()


if __name__ == "__main__":
    main()
