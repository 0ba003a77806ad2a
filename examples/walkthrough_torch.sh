#!/usr/bin/env bash
# The walkthrough of examples/walkthrough.sh through the PyTorch port, on
# the CPU: train with write-behind checkpointing, die mid-run, restore from
# the emergency checkpoint, verify the state; then the same with retention
# and delta checkpoints.  tests/test_torch_walkthrough.py runs this script.
# On the card, drop --device cpu (or run python3 chip_smoke.py, phase
# trainer, for full width).
set -euo pipefail
cd "$(dirname "$0")/.."
export PYTHONPATH=src${PYTHONPATH:+:$PYTHONPATH}

WORK="${WORK:-$(mktemp -d)}"
echo "== walkthrough (repro_torch): working under $WORK"

TRAIN="python -m repro_torch.launch.train --arch tinyllama-1.1b --smoke
       --device cpu --steps 8 --batch 2 --seq 32 --ckpt-every 4
       --shards 2 --records-per-shard 32
       --data $WORK/data --ckpt $WORK/ckpt"

echo "== 1. train with write-behind checkpointing, kill at step 6"
if $TRAIN --kill-at 6; then
    echo "expected the simulated node failure to abort the run" >&2
    exit 1
fi
echo "   (died as intended; an emergency checkpoint was written)"

echo "== 2. rerun the same command: restores and finishes"
$TRAIN | tee "$WORK/resume.log"
grep -q "restored step" "$WORK/resume.log"
grep -q "done: step 8" "$WORK/resume.log"

echo "== 3. verify the committed checkpoint restores cleanly"
python - "$WORK/ckpt" <<'PY'
import sys
from repro_torch.core import OSDevice
from repro_torch.checkpoint import CheckpointManager

mgr = CheckpointManager(OSDevice(), sys.argv[1], num_shards=4)
steps = mgr.committed_steps()
assert steps, "no committed checkpoints found"
out = mgr.restore_latest()
assert out is not None, "latest checkpoint failed validation"
step, tree, extra = out
assert step == max(steps) and int(extra["step"]) >= 8, (step, extra)
print(f"   restored step {step} OK: {len(tree)} leaves, extra={extra}")
mgr.fa.shutdown()
PY

echo "== 4. lifecycle: retention + delta checkpoints survive a mid-run kill"
LC="python -m repro_torch.launch.train --arch tinyllama-1.1b --smoke
    --device cpu --steps 11 --batch 2 --seq 32 --ckpt-every 2
    --shards 2 --records-per-shard 32
    --keep-last 2 --delta-every 1
    --data $WORK/data --ckpt $WORK/ckpt-lc"
if $LC --kill-at 9; then
    echo "expected the simulated node failure to abort the run" >&2
    exit 1
fi
$LC | tee "$WORK/resume-lc.log"
grep -q "restored step" "$WORK/resume-lc.log"
grep -q "done: step 11" "$WORK/resume-lc.log"

python - "$WORK/ckpt-lc" <<'PY'
import sys
from repro_torch.core import OSDevice
from repro_torch.checkpoint import CheckpointManager

mgr = CheckpointManager(OSDevice(), sys.argv[1], num_shards=4)
steps = mgr.committed_steps()
assert steps and max(steps) == 11, steps
assert 2 not in steps and len(steps) <= 4, f"retention did not collect: {steps}"
kinds = {s: mgr.read_manifest(s)["kind"] for s in steps}
assert "delta" in kinds.values(), kinds
for s, k in kinds.items():
    if k == "delta":
        assert mgr.read_manifest(s)["base"] in steps, (s, steps)
out = mgr.restore_latest()
assert out is not None, "latest checkpoint failed validation"
step, tree, extra = out
print(f"   lifecycle OK: kept {steps} ({sorted(kinds.values())}), restored step {step}")
mgr.fa.shutdown()
PY

echo "== walkthrough (repro_torch) OK"
