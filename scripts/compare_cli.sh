#!/bin/bash
# Compare two checkouts of the port end to end on one card, in turns
# (parent, change, change, parent): the CLI's renders at 720x480 of
# stress-500 (8 spp), doom_standin (4 spp), dragon_standin (2 spp) and
# env_demo with --env-nee (4 spp) from each tree, their "scene built" and
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
SCENES=("s::--spp 8" "d:scenes/doom_standin.yml:--spp 4" "g:scenes/dragon_standin.yml:--spp 2"
        "e:scenes/env_demo.yml:--spp 4 --env-nee")
for lab in parent change change parent; do
  if [ $lab = parent ]; then D=$P; else D=$C; fi
  for sc in "${SCENES[@]}"; do
    IFS=: read -r tag yml args <<< "$sc"
    # shellcheck disable=SC2086
    r=$(cd "$D" && python -m paths_tpu_torch.cli $yml -o "$OUT/${tag}_$lab.png" $args 2>&1 | grep -E "scene built|rendered" | tr '\n' ' ')
    echo "$lab ${yml:-stress-500} $args: $r"
  done
done
for sc in "${SCENES[@]}"; do
  IFS=: read -r tag yml args <<< "$sc"
  cmp "$OUT/${tag}_parent.png" "$OUT/${tag}_change.png" && echo "${yml:-stress-500} PNGs equal"
done
rm -rf "$OUT"
