# The parent tree (unpacked into .ab_old/parent) against this tree, in
# turns on one card (parent, change, change, parent): the bank classes
# (scratch/bank_class_ab.py, then this tree's on a (64, 4) mesh) and
# chip_smoke.py's bank-host and bank-stereo phases
# (scratch/bank_phase_ab.py).
#
#   bash scratch/chip_ab.sh OUTDIR
#
# JSON lines go to OUTDIR/bank_ab.jsonl and OUTDIR/bank_phase_ab.jsonl.
set -o pipefail
out=$(mkdir -p "${1:?usage: chip_ab.sh OUTDIR}" && cd "$1" && pwd)
rm -f "$out/bank_ab.jsonl" "$out/bank_phase_ab.jsonl"
for r in .ab_old/parent . . .ab_old/parent; do
  python3 scratch/bank_class_ab.py "$r" --out "$out/bank_ab.jsonl" || exit 1
done
python3 scratch/bank_class_ab.py . --mesh 4 --out "$out/bank_ab.jsonl" \
  || exit 1
for r in .ab_old/parent . . .ab_old/parent; do
  python3 scratch/bank_phase_ab.py "$r" --out "$out/bank_phase_ab.jsonl" \
    > /dev/null || exit 1
done
cat "$out/bank_ab.jsonl" "$out/bank_phase_ab.jsonl"
