"""Quickstart on the PyTorch port: the DS-CIM approximate MVM in five
minutes.

Runs an int8 MVM three ways -- exact (DCIM adder-tree baseline), DS-CIM1
(precise), DS-CIM2 (efficient) -- through the bit-exact LUT backend,
prints Table-I-style RMSE numbers and the hardware model's efficiency
projections; the same printout as ``examples/quickstart.py``.

  PYTHONPATH=src python examples/quickstart_torch.py               # CUDA
  PYTHONPATH=src python examples/quickstart_torch.py --device cpu
"""
import argparse

import numpy as np
import torch

from repro_torch.core.hwmodel import DSCIM1_HW, DSCIM2_HW
from repro_torch.core.macro import DSCIMMacro
from repro_torch.core.seed_search import calibrated_config
from repro_torch.device import resolve_device


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="cpu to run on the CPU (default: CUDA)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    rng = np.random.default_rng(0)
    H = 128                                  # one macro column accumulation
    x = rng.integers(-128, 128, (4, H)).astype(np.int32)
    w = rng.integers(-128, 128, (H, 8)).astype(np.int32)
    exact = x @ w
    xt = torch.as_tensor(x, device=dev)
    wt = torch.as_tensor(w, device=dev)

    print("int8 MVM, 128-row accumulation window")
    print(f"  exact (adder tree): psum[0,:4] = {exact[0, :4]}")
    for variant, L in (("dscim1", 256), ("dscim2", 64)):
        for mode in ("paper", "opt"):
            mac = DSCIMMacro(calibrated_config(variant, L, mode))
            est = mac.mvm(xt, wt).cpu().numpy()
            rmse = 100 * np.sqrt(((est - exact) ** 2).mean()) / (H * 255 * 255)
            print(f"  {mac.cfg.name:22s}: psum[0,:4] ~ {est[0, :4].astype(int)}"
                  f"  RMSE {rmse:.2f}% of fullscale")

    print("\ncalibrated 40nm hardware model (paper Table III):")
    for name, hw in (("DS-CIM1 @L=256", DSCIM1_HW(256)),
                     ("DS-CIM2 @L=64", DSCIM2_HW(64))):
        s = hw.summary()
        print(f"  {name}: {s['tops_per_watt']:.0f} TOPS/W, "
              f"{s['tops_per_mm2']:.0f} TOPS/mm2, {s['area_mm2']:.2f} mm2")


if __name__ == "__main__":
    main()
