"""The port's lint CLI:

    PYTHONPATH=src python -m repro_torch.core.analysis             # report all
    PYTHONPATH=src python -m repro_torch.core.analysis --check     # vs baseline
    PYTHONPATH=src python -m repro_torch.core.analysis --update-baseline

With no paths it lints `src/repro_torch/core` with `chip_smoke.py` as the
gate file, against `src/repro_torch/core/analysis/baseline.json`, from any
working directory.
"""
import sys

from .buffetlint import main

if __name__ == "__main__":
    sys.exit(main())
