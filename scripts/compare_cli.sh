#!/bin/bash
# Compare two checkouts of the port end to end on one card, in turns
# (parent, change, change, parent): the CLI's stress-500 (8 spp) and
# doom_standin (4 spp) renders at 720x480 from each tree, their
# pixel-samples/s lines, and whether the two trees' PNGs are equal.
#
#   bash scripts/compare_cli.sh PARENT_DIR CHANGE_DIR
#
# Each directory is a checkout (for example `git archive <commit> | tar -x`).
set -u
P=$1
C=$2
OUT=$(mktemp -d)
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
for lab in parent change change parent; do
  if [ $lab = parent ]; then D=$P; else D=$C; fi
  s=$(cd "$D" && python -m paths_tpu_torch.cli -o "$OUT/s_$lab.png" --spp 8 2>&1 | grep "rendered")
  d=$(cd "$D" && python -m paths_tpu_torch.cli scenes/doom_standin.yml -o "$OUT/d_$lab.png" --spp 4 2>&1 | grep "rendered")
  echo "$lab stress-500: $s"
  echo "$lab doom: $d"
done
cmp "$OUT/s_parent.png" "$OUT/s_change.png" && echo "stress-500 PNGs equal"
cmp "$OUT/d_parent.png" "$OUT/d_change.png" && echo "doom PNGs equal"
rm -rf "$OUT"
