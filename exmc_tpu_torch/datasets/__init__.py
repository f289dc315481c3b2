"""The real datasets the JAX package ships (``exmc_tpu/datasets``), read
in place from ``exmc_tpu/datasets/data/*.csv``: the port keeps no copy of
the files, only of the loaders.

* kilpisjarvi-summer-temp.csv: mean summer temperatures at Kilpisjärvi
  (Finland), 1952-2013;
* diabetes.csv: the Pima Indians Diabetes dataset (768 patients,
  8 predictors, binary outcome);
* the bda-cyber CSVs (AV-TEST detection counts and others), through
  ``load_csv``.
"""

import os

import numpy as np

_DATA = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "exmc_tpu", "datasets", "data")


def _path(name):
    return os.path.join(_DATA, name)


def load_kilpisjarvi():
    """{"year" (int), "temp_june"/"temp_july"/"temp_august",
    "temp_summer"} of the Kilpisjärvi record."""
    raw = np.genfromtxt(_path("kilpisjarvi-summer-temp.csv"),
                        delimiter=";", names=True, dtype=float)
    return {
        "year": raw["year"].astype(int),
        "temp_june": raw["tempjune"],
        "temp_july": raw["tempjuly"],
        "temp_august": raw["tempaugust"],
        "temp_summer": raw["tempsummer"],
    }


def load_diabetes():
    """Pima Indians Diabetes: X (768, 8) float features, y (768,) binary
    outcome, and the feature names."""
    raw = np.genfromtxt(_path("diabetes.csv"), delimiter=",",
                        names=True, dtype=float)
    names = [n for n in raw.dtype.names if n != "Outcome"]
    X = np.stack([raw[n] for n in names], axis=1)
    y = raw["Outcome"].astype(np.int32)
    return {"X": X, "y": y, "feature_names": names}


def load_csv(name):
    """Raw structured-array access to any bundled CSV (e.g.
    ``"avtest_detection"``)."""
    delim = ";" if "kilpisjarvi" in name else ","
    fname = name if name.endswith(".csv") else name + ".csv"
    return np.genfromtxt(_path(fname), delimiter=delim, names=True,
                         dtype=None, encoding="utf-8")
