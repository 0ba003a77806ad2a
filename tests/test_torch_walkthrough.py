"""examples/walkthrough_torch.sh end to end on the CPU: train the port with
write-behind checkpoints, die at step 6, restore from the emergency
checkpoint and finish, verify the committed checkpoint with the port's
CheckpointManager; then the same with retention and delta checkpoints."""

import os
import subprocess
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def test_torch_walkthrough(tmp_path):
    env = dict(os.environ, WORK=str(tmp_path))
    res = subprocess.run(["bash", str(ROOT / "examples" / "walkthrough_torch.sh")],
                         env=env, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout[-4000:] + res.stderr[-4000:]
    out = res.stdout
    assert "restored step 6 -> resuming at (epoch 0, step 6)" in out
    assert "done: step 8" in out and "restored step 8 OK" in out
    assert "lifecycle OK" in out and out.rstrip().endswith("== walkthrough (repro_torch) OK")
