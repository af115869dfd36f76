"""Times the paged decode kernel (K2) of the tree it runs in at serving
shapes: phase 3's lengths, 8 x 512, 8 x 513..533 (the serve profile's
steady state) and 1 x 512 (H 12, D 64, page 16), under a bf16 query over
bf16/int8/int4 pools and an fp32 query over an fp32 pool, each checked
against the plain version first (chip_smoke.time_ms: cold L2, median of
25).

    cd <a checkout of the repository> && python3 <path>/k2_serving_shapes.py

It imports chip_smoke and nanosandbox_tpu_torch from the working
directory, so the same script times two commits in turns.
"""
import sys

import numpy as np
import torch

sys.path.insert(0, ".")
import chip_smoke as cs  # noqa: E402
from nanosandbox_tpu_torch.ops import flash_decode as fd  # noqa: E402

rng = np.random.default_rng(11)
H, D = 12, 64
cases = {"phase3": np.array([1024, 1, 517, 300, 16, 17, 1, 1], np.int32),
         "8x512": np.full(8, 512, np.int32),
         "8x513-533": np.arange(513, 534, 3, dtype=np.int32)[:8],
         "1x512": np.full(1, 512, np.int32)}
data = {}
for name, lens in cases.items():
    k, v, tbl = cs.make_case(rng, len(lens), lens)
    data[name] = (k, v, tbl, torch.from_numpy(lens).to("cuda"))
for qdt, modes in ((torch.bfloat16, ("bf16", "int8", "int4")),
                   (torch.float32, ("fp32",))):
    for mode in modes:
        row = []
        for name, (k, v, tbl, n) in data.items():
            q = torch.randn(len(n), H, D, device="cuda").to(qdt)
            (kk, ks), (vv, vs) = (cs.pool_in_mode(k, mode),
                                  cs.pool_in_mode(v, mode))
            kw = {} if ks is None else dict(k_scale=ks, v_scale=vs)
            got = fd.flash_decode_paged(q, kk, vv, tbl, n, **kw)
            ref = fd.torch_decode_attention_paged(q, kk, vv, tbl, n, **kw)
            cs.check_limits(f"{name} {mode}", got, ref, qdt)
            ms = cs.time_ms(lambda: fd.flash_decode_paged(q, kk, vv, tbl, n,
                                                          **kw))
            row.append(f"{name} {ms:.5f}")
        print(f"q {str(qdt)[6:]} kv {mode}: " + "; ".join(row), flush=True)
