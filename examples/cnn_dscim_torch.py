"""Table-I accuracy methodology end to end on the PyTorch port (CIFAR
stand-in): the same printout as ``examples/cnn_dscim.py``.

Train a small classifier in float -> quantize every MVM to int8 ->
evaluate exact int8 against DS-CIM1/DS-CIM2 (paper-style injection and
the bit-exact LUT), reporting accuracy drops: the paper's
ResNet18/CIFAR-10 experiment shape, on a synthetic 10-class task (no
datasets offline), through ``repro_torch.paper.t1_accuracy.run``.

  PYTHONPATH=src python examples/cnn_dscim_torch.py --steps 300             # CUDA
  PYTHONPATH=src python examples/cnn_dscim_torch.py --steps 3 --device cpu
"""
import argparse

from repro_torch.paper.t1_accuracy import run


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--device", default=None,
                    help="cpu to run on the CPU (default: CUDA)")
    args = ap.parse_args(argv)
    rows = run(steps=args.steps, device=args.device)
    print(f"{'config':28s} {'accuracy':>9s} {'drop':>8s}")
    for r in rows:
        print(f"{r['name']:28s} {r['acc']:9.4f} {r['drop']:+8.4f}")
    print("\n(cf. paper Table I: ResNet18@CIFAR10 94.54% float ->"
          " 94.45% DS-CIM1/L256, 94.31% DS-CIM2/L256)")


if __name__ == "__main__":
    main()
