from .el import ELConfig, el_round  # noqa: F401
