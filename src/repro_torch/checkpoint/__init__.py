from . import ckpt
