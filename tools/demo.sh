#!/usr/bin/env bash
# End-to-end demo of the framework's surfaces. Steps 1-4 force the CPU
# backend so they run anywhere; step 5 (the GPU benchmark) runs only where
# nvidia-smi finds a card, after the server process has exited (one
# process per card).
set -euo pipefail
cd "$(dirname "$0")/.."
TMP=$(mktemp -d)
PY() { python -c "
import jax; jax.config.update('jax_platforms','cpu')
import sys; sys.argv = ['sdrangel_tpu'] + '$*'.split('|')
from sdrangel_tpu.__main__ import main; main()"; }

echo '=== 1. Tx: modulate a CW-keyed NFM signal at +50 kHz into a capture ==='
PY "mod|--channel|nfm:50000|--cw|cq cq de sdrangel|--seconds|2|--out|$TMP/tx.sdriq"

echo '=== 2. inspect the capture ==='
PY "info|--in|$TMP/tx.sdriq"

echo '=== 3. Rx: demodulate it back to audio ==='
PY "demod|--in|$TMP/tx.sdriq|--channel|nfm:50000|--squelch|-60|--out|$TMP/rx.wav"
ls -la "$TMP/rx.wav"

echo '=== 4. REST control plane ==='
python -c "
import jax; jax.config.update('jax_platforms','cpu')
import sys; sys.argv=['x','server','--api-port','18095']
from sdrangel_tpu.__main__ import main; main()" &
SRV=$!
sleep 3
curl -s http://127.0.0.1:18095/sdrangel | head -c 200; echo
curl -s -X POST http://127.0.0.1:18095/sdrangel/devicesets -d '{}'
curl -s -X PATCH http://127.0.0.1:18095/sdrangel/deviceset/0/device/settings \
  -d '{"kind":"testsource","sample_rate":192000.0,"modulation":"fm","carrier_freq":20000.0}' > /dev/null
curl -s -X POST http://127.0.0.1:18095/sdrangel/deviceset/0/channel \
  -d '{"channelType":"sdrangel.channel.nfmdemod","inputFrequencyOffset":20000.0,"squelch_db":-60.0}'
curl -s -X POST http://127.0.0.1:18095/sdrangel/deviceset/0/device/run > /dev/null
sleep 8
echo; echo '--- channel report ---'
curl -s http://127.0.0.1:18095/sdrangel/deviceset/0/channel/0/report; echo
echo '--- fetch 1s of demod audio as WAV ---'
curl -s http://127.0.0.1:18095/sdrangel/deviceset/0/channel/0/audio -o "$TMP/http.wav"
ls -la "$TMP/http.wav"
curl -s -X DELETE http://127.0.0.1:18095/sdrangel/deviceset/0/device/run > /dev/null
kill $SRV 2>/dev/null || true
wait $SRV 2>/dev/null || true

echo '=== 5. benchmark (needs a GPU) ==='
if nvidia-smi -L > /dev/null 2>&1; then
  python bench.py
else
  echo 'no GPU found: benchmark skipped'
fi

echo "demo artifacts in $TMP"
