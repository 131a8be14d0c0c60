"""train_dev.k4_roofline: train.k4_roofline's reading, in a training cell
judged by its device time a step (it moves train_device_ms_per_step there)."""
import os
import runpy

read = runpy.run_path(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                   "train.k4_roofline.py"))["read"]
