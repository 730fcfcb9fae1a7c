"""Raw exchange-rate prices into demeaned log-returns (an offline step).

Counterpart of ``demo/exchange_rate/process_exchange_data.py``: reads a
Finam-format CSV (<DATE>, <TIME>, <CLOSE> columns), computes demeaned
log-returns at minute / hourly / daily granularity (the hour and day
series take the first price of each bucket) and writes a compressed npz
with the keys the demos read.  pandas is imported only by ``process``.

Usage: python -m sgmcmc_tpu_torch.demo.exchange_rate.process_exchange_data
    [raw.csv] [out.npz]
"""
import sys

import numpy as np


def demeaned_log_returns(close) -> np.ndarray:
    lr = np.diff(np.log(np.asarray(close, dtype=float)))
    return lr - lr.mean()


def process(raw_csv: str, out_npz: str) -> dict:
    import pandas as pd
    df = pd.read_csv(raw_csv, dtype={"<DATE>": str, "<TIME>": str})
    dates = pd.to_datetime(df["<DATE>"] + df["<TIME>"], format="%Y%m%d%H%M%S")
    close = df["<CLOSE>"].astype(float)

    out = {}
    # minute granularity: every row
    out["minute_log_returns"] = demeaned_log_returns(close)
    out["minute_date"] = np.asarray(dates.iloc[1:], dtype="datetime64[m]")

    # hourly / daily: first price within each bucket
    for name, floor in [("hourly", "h"), ("daily", "D")]:
        bucket = dates.dt.floor(floor)
        first = close.groupby(bucket).first()
        out[f"{name}_log_returns"] = demeaned_log_returns(first)
        out[f"{name}_date"] = np.asarray(
            first.index[1:],
            dtype="datetime64[h]" if name == "hourly" else "datetime64[D]")

    np.savez_compressed(out_npz, **out)
    return out


if __name__ == "__main__":
    raw = sys.argv[1] if len(sys.argv) > 1 else "./data/EURUS_data.csv"
    out = sys.argv[2] if len(sys.argv) > 2 else "./data/EURUS_processed.npz"
    data = process(raw, out)
    for k, v in data.items():
        print(k, getattr(v, "shape", None))
