#!/usr/bin/env bash
# The flagship's step on a 2 x 2 (data, model) mesh across the four cards
# of one host: scripts/tp_cards.py under torchrun, one rank a card over
# NCCL (chip_smoke.py's phase 18 runs the same step with 4 ranks on one
# card over gloo). Builds the chain kernel once first, so that the ranks
# do not all compile it; then prints the run's exit code and every
# card's name and power limit.
#
#   bash scripts/tp_cards.sh
set -u
root=$(cd "$(dirname "$0")/.." && pwd)
export PYTHONPATH="$root${PYTHONPATH:+:$PYTHONPATH}"
python3 -c "from inverse_flow_tpu_torch.ops import _build; _build.build('chain_solve')" || exit 1
timeout 600 python3 -m torch.distributed.run --standalone \
    --nproc_per_node=4 "$root/scripts/tp_cards.py"
rc=$?
echo "tp_cards: rc $rc"
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
exit $rc
