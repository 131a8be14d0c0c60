"""train_dev.gather_bwd_pct: train.gather_bwd_pct's reading, in a training
cell judged by its device time a step (it moves train_device_ms_per_step
there)."""
import os
import runpy

read = runpy.run_path(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                   "train.gather_bwd_pct.py"))["read"]
