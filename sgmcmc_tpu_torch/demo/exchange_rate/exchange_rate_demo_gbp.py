"""EUR/GBP exchange-rate demo: the EUR/US demo on the GBP series.

Counterpart of ``demo/exchange_rate/exchange_rate_demo_gbp.py``: the same
workflow, reading ``data/EURGBP_processed.npz`` beside this module unless
``--data`` is given (prepare it from a raw price file with
``process_exchange_data.py EURGBP_data.csv data/EURGBP_processed.npz``).

Usage: python -m sgmcmc_tpu_torch.demo.exchange_rate.exchange_rate_demo_gbp
    [--data PATH.npz] [other demo arguments]
"""
import os
import sys

from . import exchange_rate_demo

DEFAULT_GBP_DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "data", "EURGBP_processed.npz")


def main(argv=None) -> dict:
    argv = list(sys.argv[1:] if argv is None else argv)
    if "--data" not in argv:
        argv += ["--data", DEFAULT_GBP_DATA]
    return exchange_rate_demo.main(argv)


if __name__ == "__main__":
    main()
