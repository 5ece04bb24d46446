import os
import sys
from pathlib import Path

# small tensors: more threads only contend (set before torch is loaded)
os.environ.setdefault("OMP_NUM_THREADS", "1")
os.environ.setdefault("MKL_NUM_THREADS", "1")
import torch  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))
torch.set_num_threads(1)
