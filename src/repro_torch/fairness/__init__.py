from .metrics import demographic_parity, equalized_odds, fair_accuracy  # noqa: F401
