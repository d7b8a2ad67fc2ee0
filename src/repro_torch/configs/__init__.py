"""Architecture registry of the port: ``--arch <id>`` for the archs ported
so far. The reference's other archs raise a ``KeyError`` from
``get_config`` that names ``ROADMAP.md``."""
from repro_torch.models.base import register

from . import llama3p2_1b, rwkv6_1p6b

ARCH_MODULES = {
    "llama3.2-1b": llama3p2_1b,
    "rwkv6-1.6b": rwkv6_1p6b,
}

for _id, _mod in ARCH_MODULES.items():
    register(_id, lambda smoke=False, _m=_mod: _m.make(smoke=smoke))
