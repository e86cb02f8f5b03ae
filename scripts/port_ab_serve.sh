#!/usr/bin/env bash
# Interleaved A/B of the PyTorch port's serving phase on one card.
#
#   bash scripts/port_ab_serve.sh PARENT_DIR CHANGE_DIR
#
# PARENT_DIR and CHANGE_DIR are checkouts of two commits (e.g. unpacked
# `git archive` trees under build/). Runs phase 5 of each tree's
# chip_smoke.py (SamplerService over HTTP, bf16, batch 32, 250 DDIM steps)
# in the order parent, change, change, parent, in one process per run, and
# prints one "AB <dir> <served images/s> <request seconds>" line per run.
set -euo pipefail
run() {
  (cd "$1" && python3 -c "
import torch
import chip_smoke
from ccdm_tpu_torch.ops import _build
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
_build.load('attn_block')
r = chip_smoke.serve_main_path(torch.device('cuda'), chip_smoke.card_line())
print('AB', '$1', r['images_per_s'], r['request_s'])
" | grep '^AB')
}
run "$1"; run "$2"; run "$2"; run "$1"
