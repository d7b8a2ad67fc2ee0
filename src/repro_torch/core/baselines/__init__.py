from .dac import DACConfig, dac_round, init_dac_extra  # noqa: F401
from .deprl import DeprlConfig, deprl_round  # noqa: F401
from .dpsgd import DpsgdConfig, dpsgd_round  # noqa: F401
from .el import ELConfig, el_round  # noqa: F401
