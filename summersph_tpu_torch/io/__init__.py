"""The reference `.txt` IC / snapshot format and npz checkpoints."""

from .txt import read_ic_txt, write_snapshot_txt, save_path
from .checkpoint import save_npz, load_npz, load_npz_with_config

__all__ = ["read_ic_txt", "write_snapshot_txt", "save_path", "save_npz",
           "load_npz", "load_npz_with_config"]
