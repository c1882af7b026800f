#!/usr/bin/env bash
# Data parallelism across the cards of one host, through the port's CLI
# under torchrun: each data-parallel registry name for one epoch on
# synthetic ImageNet32, at a world of one and of N cards, each run in its
# own directory under chiprun_out/dp_cards/ (metrics and log; the
# checkpoint is deleted).
# Prints each run's exit code, summary line, and rank 0's "Batch Time
# Mean" (ms/step, CUDA events) and peak memory, then the card's name and
# power limit. A multi-card run that fails stops the rest.
#
#   bash scripts/dp_cards.sh [N]     # N cards, default 4
set -u
cards=${1:-4}
root=$(cd "$(dirname "$0")/.." && pwd)
export PYTHONPATH="$root${PYTHONPATH:+:$PYTHONPATH}"
# if_multiGPU_imagenet32's batch of 250 splits over 1, 2 or 5 ranks
for run in "if_multiGPU_imagenet32 1" "if_multiGPU_imagenet32 2" \
           "if_imagenet_multi_gpu 1" "if_imagenet_multi_gpu $cards"; do
    set -- $run
    dir="$root/chiprun_out/dp_cards/$1_w$2"
    rm -rf "$dir" && mkdir -p "$dir"
    (cd "$dir" && timeout 240 python3 -m torch.distributed.run --standalone \
        --nproc_per_node="$2" -m inverse_flow_tpu_torch.cli --name "$1" \
        --epochs 1 > run.log 2>&1)
    rc=$?
    echo "dp_cards: $1 world $2: rc $rc; $(tail -n 1 "$dir/run.log")"
    grep -h '"summary/Batch Time Mean"\|"Memory peak_mb"' \
        "$dir"/*_metrics.jsonl 2>/dev/null | sed "s/^/dp_cards: $1 world $2: /"
    rm -f "$dir"/*_checkpoint.pt        # tens of MB each
    if [ "$rc" -ne 0 ] && [ "$2" -gt 1 ]; then
        break
    fi
done
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
