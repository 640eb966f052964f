#!/bin/bash
# The card run recorded in this directory, in one command on a machine with
# one NVIDIA GPU (nothing of the run is kept there afterwards, so training,
# both backfills and the seed agreement run in one go):
#
#   TRAIN_LIMIT=2900 BACKFILL_LIMIT=220 bash runs/fvd_demo_torch/run.sh
#
# It trains the quality demo for 500 kimg with the JAX run's knobs
# (runs/fvd_demo_r5), re-scores every snapshot under detector seeds 18 and
# 19, checks that the three series rank the snapshots alike, and copies what
# it keeps into chiprun_out/fvd_demo_torch/. The zip is written from seed 0
# when absent; the metric stats cache goes in a HOME of its own. The paths
# in the recorded logs are relative to the repository.
cd "$(dirname "$0")/../.."
RUN=_archive/fvd_demo_torch
OUT=chiprun_out/fvd_demo_torch
mkdir -p $OUT
export HOME=$(pwd)/_archive/home          # the metric stats cache
export PYTHONFAULTHANDLER=1               # a traceback if the process takes a fatal signal
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader | tee $OUT/smi.txt
CMD="python -m stylegan_v_tpu_torch.train_fvd_demo --outdir $RUN --data _archive/moving64.zip --total-kimg 500 --kimg-per-tick 8 --snap-ticks 2 --gamma 1.0 --augment-p 0.2 --ada-kimg 50 --ada-target 0.6 --workers 3"
echo "\$ $CMD" > $OUT/command.txt
T0=$(date +%s)
timeout ${TRAIN_LIMIT:-2900} $CMD > $OUT/train.out 2> $OUT/train.err
echo "train rc=$? in $(( $(date +%s) - T0 )) s" | tee -a $OUT/timeline.txt
cp $RUN/stats.jsonl $RUN/metric-fvd2048_16f.jsonl $RUN/log.txt $RUN/*.jpg $OUT/
for s in 18 19; do
  T1=$(date +%s)
  timeout ${BACKFILL_LIMIT:-220} python -m stylegan_v_tpu_torch.fvd_demo_backfill --outdir $RUN \
      --data _archive/moving64.zip --detector-seed $s \
      --out-jsonl $OUT/metric-fvd2048_16f.seed$s.jsonl --force > $OUT/backfill$s.out 2>&1
  echo "backfill $s rc=$? in $(( $(date +%s) - T1 )) s" | tee -a $OUT/timeline.txt
done
python scripts/fvd_seed_agreement.py $OUT/metric-fvd2048_16f.jsonl \
    $OUT/metric-fvd2048_16f.seed18.jsonl $OUT/metric-fvd2048_16f.seed19.jsonl \
    | tee $OUT/agreement.txt
python3 - <<'PY' | tee $OUT/zip.txt
import hashlib, zipfile
p = "_archive/moving64.zip"
print("zip sha256", hashlib.sha256(open(p, "rb").read()).hexdigest())
with zipfile.ZipFile(p) as zf:
    names = sorted(zf.namelist())
    print(len(names), "members, sha256 of the sorted members' bytes",
          hashlib.sha256(b"".join(zf.read(n) for n in names)).hexdigest())
PY
echo "total $(( $(date +%s) - T0 )) s" | tee -a $OUT/timeline.txt
