#!/usr/bin/env bash
# Train then evaluate DSTD-GCN on cmu (one GPU). Counterpart of the
# reference's scripts/dstdgcn_cmu.sh (single-GPU CUDA pinning dropped:
# device selection is JAX_PLATFORMS / mesh-driven here).
set -e
cd "$(dirname "$0")/.."

time=$(date "+%Y%m%d")
exp_name="${time}_dstdgcn_cmu"
save_dir="runs/${exp_name}"
mkdir -p "${save_dir}"

# Training
python main.py --exp_name "${exp_name}" --run_dir "${save_dir}" \
    --config configs/dstdgcn_cmu.yaml

# Testing (expects the checkpoint path in the test config; override by
# editing model.ckpt or pointing it at ${save_dir}/checkpoints/best.ckpt)
python main.py --exp_name "${exp_name}" --run_dir "${save_dir}" \
    --config configs/dstdgcn_cmu_test.yaml
