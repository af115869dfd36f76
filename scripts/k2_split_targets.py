"""Times the port's paged decode kernel (K2) under several split targets.

    python3 scripts/k2_split_targets.py      (from the repository root, on a GPU)

``ops/flash_decode.SPLIT_BLOCKS_PER_SM`` sets how many blocks a K2 launch
aims at per SM (decode_splits); this script sets it to 1, 2 and 4 in turn
and times K2 (chip_smoke.time_ms: cold L2, median of 25) at phase 3's
lengths, 8 rows x 512 and 1 row x 512 (H 12, D 64, page 16), under a bf16
query over bf16/int8/int4 pools and an fp32 query over fp32/int8/int4,
each checked against the plain version first. It also prints the floor
of the timing: a one-element fill.
"""
import sys

import numpy as np
import torch

sys.path.insert(0, ".")
import chip_smoke as cs  # noqa: E402
from nanosandbox_tpu_torch.ops import flash_decode as fd  # noqa: E402

rng = np.random.default_rng(7)
H, D = 12, 64
cases = {"phase3": np.array([1024, 1, 517, 300, 16, 17, 1, 1], np.int32),
         "serve": np.full(8, 512, np.int32),
         "serve1": np.full(1, 512, np.int32)}
data = {}
for name, lens in cases.items():
    k, v, tbl = cs.make_case(rng, len(lens), lens)
    data[name] = (k, v, tbl, torch.from_numpy(lens).to("cuda"))
tiny = torch.zeros(1, device="cuda")
print(f"floor: one-element fill {cs.time_ms(lambda: tiny.zero_()):.5f} ms",
      flush=True)
for target in (1, 2, 4):
    fd.SPLIT_BLOCKS_PER_SM = target
    for qdt in (torch.bfloat16, torch.float32):
        for mode in (("bf16" if qdt == torch.bfloat16 else "fp32"), "int8",
                     "int4"):
            row = []
            for name, (k, v, tbl, n) in data.items():
                q = torch.randn(len(n), H, D, device="cuda").to(qdt)
                (kk, ks), (vv, vs) = (cs.pool_in_mode(k, mode),
                                      cs.pool_in_mode(v, mode))
                kw = {} if ks is None else dict(k_scale=ks, v_scale=vs)
                got = fd.flash_decode_paged(q, kk, vv, tbl, n, **kw)
                ref = fd.torch_decode_attention_paged(q, kk, vv, tbl, n, **kw)
                cs.check_limits(f"{name} {mode}", got, ref, qdt)
                S, _ = fd.decode_splits(len(n), H, tbl.shape[1], 16,
                                        fd._sm_count(q.device))
                ms = cs.time_ms(lambda: fd.flash_decode_paged(
                    q, kk, vv, tbl, n, **kw))
                row.append(f"{name} S={S} {ms:.5f}")
            print(f"target {target} q {str(qdt)[6:]} kv {mode}: "
                  + "; ".join(row), flush=True)
