#!/usr/bin/env bash
# End-to-end verification of the PyTorch port (twin of scripts/verify.sh):
# the port's CPU tests, the crosscheck against the native oracle on the
# CPU, the examples; with a CUDA card also the -m cuda tests, chip_smoke.py
# and the crosscheck in float32 on the card.
#
#   bash scripts/verify_torch.sh            # DFTSIZE, HOPSIZE, WINDOW, LATENCY
#                                           # and WAV (default: a seeded noise
#                                           # WAV) override the crosscheck
set -euo pipefail
cd "$(dirname "$0")/.."

DFTSIZE="${DFTSIZE:-1000}"
HOPSIZE="${HOPSIZE:-100}"
WINDOW="${WINDOW:-hann}"
LATENCY="${LATENCY:-1}"
WAV=(${WAV:+"$WAV"})
# the JAX package the tests and the oracle's import hold the port against
# stays on the CPU
export JAX_PLATFORMS=cpu

if python -c 'import sys, torch; sys.exit(0 if torch.cuda.is_available() else 1)'; then
  CARD=1; DEVICE=cuda:0
else
  CARD=0; DEVICE=cpu
fi

echo "== the port's CPU tests =="
python -m pytest tests/test_torch_*.py -q -p no:randomly

echo "== crosscheck on the CPU ($DFTSIZE $HOPSIZE $WINDOW $LATENCY, float64) =="
python scripts/crosscheck_torch.py "$DFTSIZE" "$HOPSIZE" "$WINDOW" "$LATENCY" \
    "${WAV[@]}" --device cpu

echo "== examples ($DEVICE) =="
OUT="$(mktemp -d)"
trap 'rm -rf "$OUT"' EXIT
python examples/analysis_torch.py --device "$DEVICE" --out "$OUT"
python examples/latency_torch.py --device "$DEVICE"
python examples/precision_torch.py --device "$DEVICE"
python examples/stft_window_test_torch.py --device "$DEVICE"
python examples/streaming_torch.py --device "$DEVICE"
python examples/transform_torch.py --device "$DEVICE" --out "$OUT"

if [ "$CARD" = 1 ]; then
  echo "== the -m cuda tests =="
  python -m pytest tests -m cuda -q -p no:randomly
  echo "== chip_smoke.py =="
  python3 chip_smoke.py
  echo "== crosscheck on the card ($DFTSIZE $HOPSIZE $WINDOW $LATENCY, --fd32) =="
  python scripts/crosscheck_torch.py "$DFTSIZE" "$HOPSIZE" "$WINDOW" "$LATENCY" \
      "${WAV[@]}" --fd32
else
  echo "== no CUDA card; skipping the card's tier =="
fi

echo "verify_torch OK"
