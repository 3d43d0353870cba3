from . import adm, vdm  # noqa: F401  (register "adm", "vdm")
from .ncsnpp import NCSNpp  # noqa: F401  (registers "ncsnpp")
from .registry import create_model, get_model  # noqa: F401
