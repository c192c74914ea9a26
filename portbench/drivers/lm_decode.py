"""Driver ``lm_decode``: sessions with histories, each taking a turn of
greedy decode through the port's LM (``models/transformer.py``), all
sessions one batch.

Set-up draws the configuration's weights (``reference/lm_weights.py``)
and loads them into the port's ``transformer.LM``, draws ``sessions``
prompts of ``prompt_len`` token ids, prefills them ``prefill_batch``
sessions a call (``transformer.prefill``) and places their caches in one
decode cache of ``prompt_len + turn_tokens`` positions.  A request is one
turn of every session: a token each, drawn from the seed, goes in at
position ``prompt_len``, then ``turn_tokens - 1`` greedy steps follow,
each a ``transformer.decode_step`` of the whole batch.  Every turn starts
again at ``prompt_len`` and writes its positions before it reads them,
so turns are independent and the cache never grows.  The loop is closed.

What is kept for the check is drawn with the request, from the seed:
``first_kept`` sessions of the stream's first turn, and of each later
turn each session with probability ``check_share``.  Their rows (a
step's logits) are copied out of the batch as each step is served and
stay on the device until the window has closed.

The check (after the window, the program's state freed) runs the plain
reference (``reference/deepseek_v2_lite.py``) on each kept session's
prompt and turn, the turn's tokens being the ones the program fed and
served, and holds the program's rows against it.  Each row reads its
largest logit gap over its largest reference logit magnitude, and the
gap by which its served token's reference logit lies below the
reference's best.  Compared are the rows' median of the first
(``logit_err_p50``), the largest of the kept turns' own medians of it
(``worst_session_err_p50``: one session served wrong), the rows' 90th
percentile of the second (``token_gap_p90``), and the rows the program
never gave (``rows_missing``): in bfloat16 the experts chosen for a
token differ from float32's in 4-42 % of the expert layers, so single
rows' largest readings are those of the float8 control too (PERF.md,
section 2).

Configuration keys: the model's own (``hidden_size`` ...), ``arch`` (the
port's ``configs`` module), ``capacity_factor``, ``compute_dtype``,
``param_dtype``, ``init``; ``smoke`` gives the configuration's sizes to
the arch's smoke configuration (the CPU tests).  Traffic keys:
``sessions``, ``prompt_len``, ``turn_tokens``, ``prefill_batch``,
``warmup``, ``first_kept``, ``check_share``.
"""

from __future__ import annotations

import dataclasses
import importlib
import time

from portbench import flops, generator
from portbench.reference import deepseek_v2_lite as reference
from portbench.reference import lm_weights

# each limit between the sound runs' largest reading over 12 seeds and
# the float8 control's smallest over 4 (PERF.md, section 2):
# logit_err_p50 0.0807 and 0.2838, worst_session_err_p50 0.1021 and
# 0.2999, token_gap_p90 0.0619 and 0.4535; a row never given is an exact
# failure
LIMITS = {"logit_err_p50": 0.16, "worst_session_err_p50": 0.18,
          "token_gap_p90": 0.22, "rows_missing": 0}
QUANTILES = ("logit_err_p50", "worst_session_err_p50", "token_gap_p90")
CHECKED = "rows_checked"
FAILED = "rows_wrong"
ATTEMPTED = "tokens"
CONTROL_ON_SERVED = True       # the control reads the served tokens


# the port's LMConfig fields and the configuration's keys for them
SIZES = {"n_layers": "num_hidden_layers", "d_model": "hidden_size",
         "n_heads": "num_attention_heads", "n_kv": "num_key_value_heads",
         "d_ff": "intermediate_size", "vocab": "vocab_size",
         "kv_lora": "kv_lora_rank", "qk_nope": "qk_nope_head_dim",
         "qk_rope": "qk_rope_head_dim", "v_head": "v_head_dim",
         "n_experts": "n_routed_experts", "n_shared": "n_shared_experts",
         "top_k": "num_experts_per_tok",
         "d_ff_expert": "moe_intermediate_size",
         "n_dense_layers": "first_k_dense_replace", "rope_theta": "rope_theta"}
# the arithmetic the port's LM has no option for: its head is the
# embedding, its top-k gates renormalised and unscaled, and its RoPE
# plain (``rope_plain``)
PORT_ARITHMETIC = {"tie_word_embeddings": True, "norm_topk_prob": True,
                   "routed_scaling_factor": 1}


def rope_plain(scaling) -> bool:
    """Whether a ``rope_scaling`` is plain RoPE: none, or YaRN at factor 1,
    which keeps every frequency and makes both of its mscale terms 1."""
    return not scaling or (scaling.get("type") == "yarn"
                           and scaling.get("factor") == 1)


def port_config(config: dict):
    """The port's ``LMConfig`` of the configuration: the arch's own, with
    the configuration's capacity factor and compute dtype; raises where
    its sizes, or the arithmetic it states, are not the port's.  With
    ``smoke`` (the CPU tests) the arch's smoke configuration takes the
    configuration's sizes."""
    import torch
    arch = importlib.import_module(
        "repro_torch.configs." + config["arch"].replace("-", "_"))
    base = arch.make_config()
    if config.get("smoke"):
        base = dataclasses.replace(arch.make_smoke_config(), **{
            a: config[k] for a, k in SIZES.items()})
    cfg = dataclasses.replace(
        base, capacity_factor=config["capacity_factor"],
        dtype=getattr(torch, config["compute_dtype"]))
    differ = {a: (getattr(cfg, a), config[k]) for a, k in SIZES.items()
              if getattr(cfg, a) != config[k]}
    differ.update({k: (v, config.get(k)) for k, v in PORT_ARITHMETIC.items()
                   if config.get(k) != v})
    if not rope_plain(config.get("rope_scaling")):
        differ["rope_scaling"] = ("plain", config.get("rope_scaling"))
    if (differ or cfg.attn != "mla"
            or cfg.param_dtype != getattr(torch, config["param_dtype"])):
        raise ValueError(f"the port's {config['arch']} is not the "
                         f"configuration: {differ}")
    return cfg


class Driver:
    def __init__(self, config: dict, traffic: dict, device, log,
                 seed: int = None):
        self.config, self.traffic, self.device, self.log = (
            config, traffic, device, log)
        self.seed = seed
        self.sessions = traffic["sessions"]
        self.start = traffic["prompt_len"]
        self.steps = traffic["turn_tokens"]

    def prepare(self) -> None:
        pass

    def requests(self, seed: int, stream: int):
        """Turns: (each session's first token, uniform over the
        vocabulary; the sessions kept for the check, in order)."""
        import numpy as np
        g = generator.rng(seed, stream)
        n, first = self.sessions, True
        while True:
            tokens = g.integers(0, self.config["vocab_size"], n)
            if first:
                kept = np.sort(g.choice(n, min(self.traffic["first_kept"], n),
                                        replace=False))
            else:
                kept = np.flatnonzero(g.random(n)
                                      < self.traffic["check_share"])
            first = False
            yield tokens, kept

    def setup(self, corpus) -> None:
        import torch
        from repro_torch.models import transformer
        cfg = port_config(self.config)
        t0 = time.perf_counter()
        tree = lm_weights.draw(self.config, self.seed, self.device)
        model = transformer.LM(cfg, tree)
        want = transformer.abstract(cfg)
        got = dict(model.named_parameters())
        for name, p in transformer.LM(cfg, want).named_parameters():
            if got[name].shape != p.shape:
                raise ValueError(f"{name}: {tuple(got[name].shape)} is not "
                                 f"the port's {tuple(p.shape)}")
        self.sync()
        t_w = time.perf_counter() - t0
        prompts = torch.as_tensor(
            lm_weights.prompts(self.config, self.sessions, self.start,
                               self.seed), device=self.device)
        length = self.start + self.steps
        cache = {k: torch.zeros(v.shape[:1] + (self.sessions, length)
                                + v.shape[3:], dtype=v.dtype,
                                device=self.device)
                 for k, v in transformer.cache_spec(cfg, 1, 1).items()}
        per = self.traffic["prefill_batch"]
        for s in range(0, self.sessions, per):
            _, some = transformer.prefill(model, prompts[s:s + per])
            for k, v in some.items():
                cache[k][:, s:s + per, :self.start] = v
            del some
        self.sync()
        self.log(f"weights drawn in {t_w:.2f} s; {self.sessions} prompts of "
                 f"{self.start} tokens prefilled in "
                 f"{time.perf_counter() - t0 - t_w:.2f} s")
        self.model, self.cache = model, cache
        self.decode_step = transformer.decode_step
        self.work = flops.decode_turn_flops(self.config, self.sessions,
                                            self.start, self.steps)

    def sync(self) -> None:
        import torch
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def serve(self, request) -> tuple:
        """One turn: ([the kept sessions' logits (K, V) at each step],
        [their tokens (K,) served at each step], the fewest rows any step
        gave)."""
        import torch
        first, kept = request
        tok = torch.as_tensor(first, device=self.device)
        idx = torch.as_tensor(kept, device=self.device)
        rows, served, given = [], [], self.sessions
        for j in range(self.steps):
            out, _ = self.decode_step(self.model, self.cache, tok,
                                      self.start + j)
            tok = torch.argmax(out, dim=-1)
            if out.shape[0] < given:        # a session left without a row
                given = out.shape[0]
            if len(kept):
                sel = idx if out.shape[0] == self.sessions else (
                    idx.clamp(max=out.shape[0] - 1))
                rows.append(out.index_select(0, sel))
                served.append(tok.index_select(0, sel))
        self.sync()
        return rows, served, given

    def units(self, request) -> dict:
        return {"tokens": self.sessions * self.steps, "steps": self.steps,
                "model_flops": self.work}

    def keep(self, request, ans, sample, share: float, whole: bool) -> list:
        """(session, its first token, logits (steps, V) or None, tokens
        served (steps,) or None) of each session the request keeps (its
        own draw: ``sample``, ``share`` and ``whole`` are the list
        drivers').  A session the program gave no row for is kept with
        None, which the check counts wrong."""
        import torch
        first, kept = request
        rows, served, given = ans
        if not len(kept):
            return []
        rows, served = torch.stack(rows, 1), torch.stack(served, 1)
        return [(int(s), int(first[s]), None, None) if s >= given else
                (int(s), int(first[s]), rows[k], served[k])
                for k, s in enumerate(kept)]

    def fixed(self) -> dict:
        return {}

    def teardown(self) -> None:
        del self.model, self.cache

    # ---- the check ------------------------------------------------------ #

    def check(self, corpus, kept: list, control: bool = False) -> dict:
        """{number: value} of the kept rows held against the reference;
        with ``control`` the reference with float8 weights stands in for
        the program's logits on the tokens the program served, and its
        own first token at each position for the served one."""
        import torch
        reference.fp32_matmuls()
        dev = self.device
        w = lm_weights.draw(self.config, self.seed, dev)
        prompts = torch.as_tensor(
            lm_weights.prompts(self.config, self.sessions, self.start,
                               self.seed), device=dev)
        by_session: dict = {}
        for item in kept:
            if item[2] is None:
                by_session.setdefault(None, []).append(item)
            else:
                by_session.setdefault(item[0], []).append(item)
        missing = len(by_session.pop(None, [])) * self.steps
        errs, gaps = [], []
        for s, items in sorted(by_session.items()):
            firsts = torch.as_tensor([i[1] for i in items], device=dev)
            served = torch.stack([i[3] for i in items]).long()
            tokens = torch.cat([firsts[:, None], served[:, :-1]], dim=1)
            if control:
                got, _ = reference.run(
                    w, self.config, tokens, self.start, wt=reference.fp8,
                    past=self._prompt(w, prompts[s:s + 1], reference.fp8))
                served = got.argmax(-1)
            else:
                got = torch.stack([i[2] for i in items]).float()
            want, _ = reference.run(w, self.config, tokens, self.start,
                                    past=self._prompt(w, prompts[s:s + 1],
                                                      None))
            errs.append((got - want).abs().amax(-1) / want.abs().amax(-1))
            gaps.append((want.amax(-1) - want.gather(
                -1, served[..., None])[..., 0]).reshape(-1))
            del got, want
        turns = torch.cat(errs) if errs else torch.zeros(0, 1, device=dev)
        gaps = torch.cat(gaps) if gaps else torch.zeros(0, device=dev)
        rows = turns.reshape(-1)
        medians = torch.stack([torch.as_tensor(_quantile(t, 0.5))
                               for t in turns]) if len(turns) else rows
        out = {"logit_err_p50": _quantile(rows, 0.5),
               "worst_session_err_p50": _quantile(medians, 1.0),
               "token_gap_p90": _quantile(gaps, 0.9),
               "rows_missing": missing,
               "rows_checked": rows.numel() + missing}
        # a statistic over its limit fails every row it was read from
        over = any(out[k] > LIMITS[k] for k in QUANTILES)
        out["rows_wrong"] = out["rows_checked"] if over else missing
        self.log("check: largest logit_err %.4f, token_gap %.4f over %d "
                 "rows of %d turns" % (_quantile(rows, 1.0),
                                       _quantile(gaps, 1.0), rows.numel(),
                                       len(turns)))
        return out

    def _prompt(self, w, prompt, wt):
        return reference.run(w, self.config, prompt, 0, collect=True,
                             head=False, wt=wt)[1]


def _quantile(x, q: float) -> float:
    """The ``q`` quantile of the rows' readings (0 for no rows); a row the
    program left as NaN or infinite reads 1e30, which every limit fails."""
    import torch
    if x.numel() == 0:
        return 0.0
    x = torch.nan_to_num(x.double(), nan=1e30, posinf=1e30, neginf=1e30)
    return float(torch.quantile(x, q))
