"""Pipeline schedules as pure logic: the task lists each pp rank runs.

Counterpart of ``neuronx_distributed_llama3_2_tpu/pipeline/scheduler.py``,
kept as the port's own copy (it imports only ``dataclasses`` and
``typing``). The JAX package's SPMD executors compile these schedules into
one program and keep the task lists as their hardware-free specification.
The port runs one process per rank, as the NxD reference does, and there
the task lists are the executor itself: :mod:`.model` walks
:class:`TrainGPipeSchedule`, :class:`Train1F1BSchedule`,
:class:`TrainInterleavedSchedule` or :class:`InferenceSchedule` for its pp
rank, task by task, with point-to-point messages between adjacent stages
(:func:`..parallel.mappings.send_forward` and its three siblings), matched
by order between each pair of ranks. :class:`InterleavedRotationPlan` and
:class:`Interleaved1F1BPlan`, the JAX executors' lock-step plans, are kept
with their cost models so that the tests hold both copies equal.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, List


@dataclasses.dataclass(frozen=True)
class PipelineTask:
    """One unit of per-rank work (reference task classes scheduler.py:4-70)."""

    mb: int  # microbatch index
    # virtual-pipeline model chunk (interleaved schedule only; reference
    # scheduler.py:319-353 model-chunk math). 0 for non-interleaved.
    chunk: int = 0


@dataclasses.dataclass(frozen=True)
class ForwardStepTask(PipelineTask):
    pass


@dataclasses.dataclass(frozen=True)
class BackwardStepTask(PipelineTask):
    pass


@dataclasses.dataclass(frozen=True)
class RecvForwardTask(PipelineTask):
    pass


@dataclasses.dataclass(frozen=True)
class SendForwardTask(PipelineTask):
    pass


@dataclasses.dataclass(frozen=True)
class RecvBackwardTask(PipelineTask):
    pass


@dataclasses.dataclass(frozen=True)
class SendBackwardTask(PipelineTask):
    pass


@dataclasses.dataclass(frozen=True)
class ReduceGradsTask(PipelineTask):
    pass


class PipeSchedule:
    """Yields, per wall-clock step, the ordered task list of one pp rank
    (reference PipeSchedule scheduler.py:73)."""

    def __init__(self, num_microbatches: int, pp_size: int, pp_rank: int):
        if not 0 <= pp_rank < pp_size:
            raise ValueError(f"pp_rank {pp_rank} out of range [0, {pp_size})")
        self.num_microbatches = num_microbatches
        self.pp_size = pp_size
        self.pp_rank = pp_rank

    @property
    def is_first(self) -> bool:
        return self.pp_rank == 0

    @property
    def is_last(self) -> bool:
        return self.pp_rank == self.pp_size - 1

    def steps(self) -> Iterator[List[PipelineTask]]:
        raise NotImplementedError

    def flat_tasks(self) -> List[PipelineTask]:
        return [t for step in self.steps() for t in step]

    def _fwd_tasks(self, mb: int) -> List[PipelineTask]:
        tasks: List[PipelineTask] = []
        if not self.is_first:
            tasks.append(RecvForwardTask(mb))
        tasks.append(ForwardStepTask(mb))
        if not self.is_last:
            tasks.append(SendForwardTask(mb))
        return tasks

    def _bwd_tasks(self, mb: int) -> List[PipelineTask]:
        tasks: List[PipelineTask] = []
        if not self.is_last:
            tasks.append(RecvBackwardTask(mb))
        tasks.append(BackwardStepTask(mb))
        if not self.is_first:
            tasks.append(SendBackwardTask(mb))
        return tasks


class InferenceSchedule(PipeSchedule):
    """Forward-only (reference scheduler.py:144)."""

    def steps(self):
        for mb in range(self.num_microbatches):
            yield self._fwd_tasks(mb)


class TrainGPipeSchedule(PipeSchedule):
    """All forwards, then all backwards (JAX's gpipe executor; equivalent
    to the reference's deprecated ``TrainSchedule`` scheduler.py:545, kept
    there as the test oracle)."""

    def steps(self):
        for mb in range(self.num_microbatches):
            yield self._fwd_tasks(mb)
        for mb in range(self.num_microbatches):
            yield self._bwd_tasks(mb)
        yield [ReduceGradsTask(-1)]


class Train1F1BSchedule(PipeSchedule):
    """1F1B (reference Train1F1BSchedule scheduler.py:157): warmup of
    ``pp_size - pp_rank - 1`` forwards (:180), steady-state alternating
    1F1B, cooldown backwards. Recv-backward is ordered *before* send-forward
    in the steady state (:227-233): on the reference's runtime the reversed
    order deadlocks the collectives. The port's sends do not block, so
    either order runs; the task order is kept as the specification."""

    @property
    def num_warmup(self) -> int:
        return min(self.pp_size - self.pp_rank - 1, self.num_microbatches)

    def steps(self):
        n, warmup = self.num_microbatches, self.num_warmup
        steady = n - warmup
        # warmup forwards
        for mb in range(warmup):
            yield self._fwd_tasks(mb)
        # steady 1F1B: fwd mb = warmup + i, bwd mb = i
        for i in range(steady):
            fwd_mb = warmup + i
            tasks: List[PipelineTask] = []
            if not self.is_first:
                tasks.append(RecvForwardTask(fwd_mb))
            tasks.append(ForwardStepTask(fwd_mb))
            if not self.is_last:
                # deadlock-avoidance order (reference scheduler.py:227-233):
                # recv-bwd must precede send-fwd, so the steady block cannot
                # reuse the plain _fwd_tasks/_bwd_tasks composition
                tasks.append(RecvBackwardTask(i))
                tasks.append(SendForwardTask(fwd_mb))
            tasks.append(BackwardStepTask(i))
            if not self.is_first:
                tasks.append(SendBackwardTask(i))
            yield tasks
        # cooldown backwards
        for mb in range(steady, n):
            yield self._bwd_tasks(mb)
        yield [ReduceGradsTask(-1)]


class TrainInterleavedSchedule(PipeSchedule):
    """Interleaved virtual-pipeline (VPP) schedule (reference
    ``TrainInterleavedSchedule`` scheduler.py:256, itself the Megatron/Apex
    interleaving): each pp rank owns ``num_model_chunks`` non-contiguous
    layer chunks, shrinking the bubble from (pp-1)/M to (pp-1)/(M·chunks).

    Pure-logic specification (hardware-free, like the reference's): the
    chunk/microbatch assignment math mirrors scheduler.py:319-353 —
    warmup = 2·(pp - rank - 1) + (chunks - 1)·pp steps (:303-309, capped at
    total), steady-state 1F1B over (step → chunk, microbatch) with backward
    running ``warmup`` steps late.

    The port's ``PipelinedCausalLM(schedule="interleaved")`` runs this
    task list on each rank (``memory_bounded_backward``); the JAX package's
    lock-step realization of it is :class:`InterleavedRotationPlan` /
    :class:`Interleaved1F1BPlan` below.
    """

    def __init__(
        self,
        num_microbatches: int,
        num_model_chunks: int,
        pp_size: int,
        pp_rank: int,
    ):
        super().__init__(num_microbatches, pp_size, pp_rank)
        if num_model_chunks < 1:
            raise ValueError(f"num_model_chunks must be >= 1, got {num_model_chunks}")
        if num_microbatches % pp_size != 0:
            # reference scheduler.py:306-309 raises the same constraint
            raise ValueError(
                f"interleaved pipeline requires num_microbatches % pp == 0, "
                f"got {num_microbatches} % {pp_size}"
            )
        self.num_model_chunks = num_model_chunks
        self.total_steps = num_microbatches * num_model_chunks
        if num_microbatches == pp_size:
            self.num_warmup = self.total_steps
        else:
            warmup = 2 * (pp_size - pp_rank - 1) + (num_model_chunks - 1) * pp_size
            self.num_warmup = min(warmup, self.total_steps)

    # -- chunk/microbatch math (reference scheduler.py:319-353) -----------

    def model_chunk_id(self, step_id: int, is_forward: bool = True) -> int:
        if not is_forward:
            step_id -= self.num_warmup
        group = self.pp_size * self.num_model_chunks
        cid = (step_id % group) // self.pp_size
        if not is_forward:
            cid = self.num_model_chunks - cid - 1
        return cid

    def microbatch_id(self, step_id: int, is_forward: bool = True) -> int:
        if not is_forward:
            step_id -= self.num_warmup
        group = self.pp_size * self.num_model_chunks
        return (step_id // group) * self.pp_size + (step_id % group) % self.pp_size

    # -- task emission ----------------------------------------------------

    def steps(self):
        total, warmup = self.total_steps, self.num_warmup
        # warmup: forwards only
        for t in range(warmup):
            yield self._chunk_fwd(t)
        # steady state: one fwd + one bwd per step
        for t in range(warmup, total):
            yield self._chunk_fwd(t) + self._chunk_bwd(t)
        # cooldown: backwards only
        for t in range(total, total + warmup):
            yield self._chunk_bwd(t)
        yield [ReduceGradsTask(-1)]

    def _chunk_fwd(self, t):
        mb = self.microbatch_id(t, True)
        ck = self.model_chunk_id(t, True)
        tasks: List[PipelineTask] = []
        # stage 0 of chunk 0 is the true pipeline entry; every other
        # (rank, chunk) receives from its predecessor
        if not (self.is_first and ck == 0):
            tasks.append(RecvForwardTask(mb, ck))
        tasks.append(ForwardStepTask(mb, ck))
        if not (self.is_last and ck == self.num_model_chunks - 1):
            tasks.append(SendForwardTask(mb, ck))
        return tasks

    def _chunk_bwd(self, t):
        mb = self.microbatch_id(t, False)
        ck = self.model_chunk_id(t, False)
        tasks: List[PipelineTask] = []
        if not (self.is_last and ck == self.num_model_chunks - 1):
            tasks.append(RecvBackwardTask(mb, ck))
        tasks.append(BackwardStepTask(mb, ck))
        if not (self.is_first and ck == 0):
            tasks.append(SendBackwardTask(mb, ck))
        return tasks


# ---------------------------------------------------------------------------
# SPMD chunked-rotation plan (the JAX executor's realization of interleaving
# under a lock-step rotation, docs/interleaved_vpp.md)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class RotationStep:
    """One lock-step rotation of the chunked SPMD executor: per-lane static
    assignments. Entries are -1 when the lane is idle that rotation."""

    chunk: List[int]      # chunk executed by lane s (-1 idle)
    mb: List[int]         # microbatch executed by lane s (-1 idle)
    admit: List[int]      # fresh microbatch admitted into lane s (-1 none)
    out_slot: List[int]   # receiver-side chunk slot the lane's output enters
                          # (-1: output discarded / microbatch exits)


@dataclasses.dataclass(frozen=True)
class InterleavedRotationPlan:
    """Host-simulated static rotation plan for interleaved VPP under SPMD.

    The Megatron interleave (reference scheduler.py:256) assigns lane ``s``
    the ``V = num_model_chunks`` non-contiguous layer chunks
    ``{v·pp + s : v < V}``. Under a lock-step SPMD rotation executor every
    lane executes one virtual stage per rotation (or idles); a microbatch at
    hop ``h`` (virtual stages completed) sits at lane ``h % pp`` chunk
    ``h // pp``, so the neighbor ppermute stays the plain lane ``s → s+1``
    ring. Because lane 0 receives returning streams (chunk wrap) while fresh
    microbatches wait, admission stalls; the deterministic simulation below
    resolves them (oldest-hop-first priority, which guarantees drain) and
    yields the full static (rotation × lane) plan plus the bubble
    accounting used by docs/interleaved_vpp.md.

    Invariant checked at construction: total active lane-rotations equals
    ``M · pp · V`` (every microbatch crosses every virtual stage exactly
    once).
    """

    num_microbatches: int
    num_model_chunks: int
    pp_size: int

    def __post_init__(self):
        M, V, pp = self.num_microbatches, self.num_model_chunks, self.pp_size
        if V < 1 or pp < 1 or M < 1:
            raise ValueError("num_microbatches, num_model_chunks, pp_size >= 1")
        steps: List[RotationStep] = []
        # slots[s][v] = microbatch whose stream waits at lane s for chunk v
        slots = [[-1] * V for _ in range(pp)]
        hops = {}  # mb -> hops completed
        next_fresh = 0
        done = 0
        active = 0
        while done < M:
            chunk = [-1] * pp
            mb = [-1] * pp
            admit = [-1] * pp
            out_slot = [-1] * pp
            outputs = []  # (dst_lane, dst_chunk, mb) after this rotation
            for s in range(pp):
                # pick the waiting stream furthest along (oldest hop count)
                # — guarantees drain and minimizes in-flight depth
                cand = [
                    (hops[slots[s][v]], v) for v in range(V) if slots[s][v] >= 0
                ]
                if cand:
                    _, v = max(cand)
                    m = slots[s][v]
                    slots[s][v] = -1
                elif s == 0 and next_fresh < M:
                    m, v = next_fresh, 0
                    hops[m] = 0
                    admit[s] = m
                    next_fresh += 1
                else:
                    continue
                chunk[s] = v
                mb[s] = m
                active += 1
                h = hops[m] + 1
                hops[m] = h
                if h == pp * V:
                    done += 1
                else:
                    outputs.append((h % pp, h // pp, m, s))
            for dst, dv, m, src in outputs:
                if slots[dst][dv] != -1:
                    # explicit raise (not a bare assert) so the SPMD
                    # executor's static routing is guarded under python -O
                    raise AssertionError(
                        f"slot collision at lane {dst} chunk {dv}"
                    )
                slots[dst][dv] = m
                out_slot[src] = dv
            steps.append(RotationStep(chunk, mb, admit, out_slot))
        if active != M * pp * V:
            raise AssertionError(
                f"conservation violated: {active} != {M}*{pp}*{V}"
            )
        object.__setattr__(self, "steps_", steps)

    @property
    def num_rotations(self) -> int:
        return len(self.steps_)

    @property
    def active_lane_rotations(self) -> int:
        return self.num_microbatches * self.pp_size * self.num_model_chunks

    @property
    def idle_lane_rotations(self) -> int:
        return self.num_rotations * self.pp_size - self.active_lane_rotations

    def cost_model(self, layers_per_lane_total: int):
        """(compute_units, permute_count) where one unit = one layer applied
        to one microbatch on one lane. Lock-step rotation cost = rotations ×
        (layers per virtual stage); permutes = rotations (one stream permute
        each)."""
        per_stage = layers_per_lane_total // self.num_model_chunks
        return self.num_rotations * per_stage * self.pp_size, self.num_rotations


@dataclasses.dataclass(frozen=True)
class InterleavedStep:
    """One rotation of the combined fwd+bwd interleaved plan — per-lane
    task assignments plus the stream-routing metadata the SPMD executor
    gathers by lane index. All lists have length pp; -1 = idle/none."""

    f_chunk: List[int]   # chunk whose fwd runs on lane s (-1 idle)
    f_mb: List[int]
    f_admit: List[int]   # 1: input is a fresh embedding (lane 0 chunk 0)
    f_final: List[int]   # 1: this fwd completes the LAST virtual stage
    b_chunk: List[int]   # chunk whose bwd runs on lane s (-1 idle)
    b_mb: List[int]
    b_first: List[int]   # 1: this bwd is the FIRST virtual stage (g == 0)
    b_read_slot: List[int]  # stash slot holding the saved fwd input
    recv_f_chunk: List[int]  # wait-slot for the incoming fwd stream (-1 drop)
    recv_b_chunk: List[int]  # wait-slot for the incoming bwd stream (-1 drop)
    head_mb: int         # microbatch whose head/CE runs this rotation (-1)


@dataclasses.dataclass(frozen=True)
class Interleaved1F1BPlan:
    """Host-simulated static plan for interleaved VPP with a 1F1B-grade
    memory-bounded backward (reference
    ``TrainInterleavedSchedule`` scheduler.py:256 interleaves fwd AND bwd
    tasks per model chunk, :319-353).

    Each rotation every lane executes at most one virtual-stage forward and
    one virtual-stage backward (the same shape as the V=1 1F1B executor's
    rotation). Forward activations wait in per-(lane, chunk) slots; saved
    stage inputs live in a per-lane stash ring whose depth is the simulated
    maximum fwd→bwd delay (``stash_depth``) — activation memory O(D), not
    O(M·V) like the autodiff (gpipe-profile) interleaved backward. The
    simulation resolves wait-slot collisions by cancelling the colliding
    task (the lane idles one rotation), so the emitted plan is
    collision-free by construction; scheduling priorities: backward first
    (frees stash), most-progressed stream first.

    Invariants checked at construction: every (mb, virtual stage) runs
    forward exactly once and backward exactly once, backward after forward,
    conservation of admissions, and stash-ring safety
    (delay < stash_depth).
    """

    num_microbatches: int
    num_model_chunks: int
    pp_size: int
    max_in_flight: "int | None" = None  # admission cap (default pp·V)

    def __post_init__(self):
        M, V, pp = self.num_microbatches, self.num_model_chunks, self.pp_size
        if V < 1 or pp < 1 or M < 1:
            raise ValueError("num_microbatches, num_model_chunks, pp_size >= 1")
        cap = self.max_in_flight or (pp * V)

        fw = [[-1] * V for _ in range(pp)]   # waiting fwd stream per chunk
        bw = [[-1] * V for _ in range(pp)]   # waiting cotangent per chunk
        # a send at rotation t rides the ppermute and lands in the
        # receiver's INBOX at rotation t+1 — the recv routing recorded in
        # step t+1 describes rotation t's sends
        prev_recv_f = [-1] * pp
        prev_recv_b = [-1] * pp
        fwd_t = {}     # (s, v, mb) -> rotation its fwd ran (stash liveness)
        done_f = set()  # (mb, g) forward completed
        done_b = set()  # (mb, g) backward completed
        next_fresh = 0
        in_flight = 0
        steps: List[InterleavedStep] = []
        max_delay = 0
        total = M * pp * V

        def g_of(s, v):
            return v * pp + s

        t = 0
        while len(done_b) < total:
            if t > 8 * (total + pp * V) + 64:
                raise AssertionError(
                    f"interleaved 1F1B planner did not converge "
                    f"(M={M}, V={V}, pp={pp})"
                )
            f_chunk = [-1] * pp
            f_mb = [-1] * pp
            f_admit = [0] * pp
            f_final = [0] * pp
            b_chunk = [-1] * pp
            b_mb = [-1] * pp
            b_first = [0] * pp
            b_read_slot = [-1] * pp
            recv_f = [-1] * pp
            recv_b = [-1] * pp
            head_mb = -1

            # -- phase 1: per-lane candidate lists, priority-ordered -------
            can_admit = next_fresh < M and in_flight < cap
            fwd_cands: List[List] = []
            bwd_cands: List[List] = []
            for s in range(pp):
                # backward: most-progressed (smallest g) first
                bwd_cands.append([
                    v for _, v in sorted(
                        (g_of(s, v), v) for v in range(V) if bw[s][v] >= 0
                    )
                ])
                # forward: waiting streams first (most-progressed / largest
                # g), admission on lane 0 as the lowest-priority fallback.
                # Measured: admission-first "Megatron warmup" flooding
                # CONGESTS the lock-step ring (collision stalls downstream)
                # — waiting-first gives strictly fewer rotations at every
                # (M, V, pp) swept
                waiting = [
                    ("wait", v) for _, v in sorted(
                        ((g_of(s, v), v) for v in range(V) if fw[s][v] >= 0),
                        reverse=True,
                    )
                ]
                cands = list(waiting)
                if s == 0 and can_admit:
                    cands.append(("admit", 0))
                fwd_cands.append(cands)

            # -- phase 2: constraint propagation — a pick whose destination
            #    slot collides downgrades to the lane's next candidate ----
            f_pick = [0 if fwd_cands[s] else None for s in range(pp)]
            b_pick = [0 if bwd_cands[s] else None for s in range(pp)]
            for _ in range(2 * pp * V + 4):
                # materialize current picks
                for s in range(pp):
                    if f_pick[s] is not None and f_pick[s] < len(fwd_cands[s]):
                        kind, v = fwd_cands[s][f_pick[s]]
                        f_admit[s] = 1 if kind == "admit" else 0
                        f_chunk[s] = v
                        f_mb[s] = (
                            next_fresh if kind == "admit" else fw[s][v]
                        )
                    else:
                        f_chunk[s] = f_mb[s] = -1
                        f_admit[s] = 0
                    if b_pick[s] is not None and b_pick[s] < len(bwd_cands[s]):
                        v = bwd_cands[s][b_pick[s]]
                        b_chunk[s], b_mb[s] = v, bw[s][v]
                    else:
                        b_chunk[s] = b_mb[s] = -1
                # slot occupancy AFTER consumption by current picks
                occ_f = {
                    (s, v) for s in range(pp) for v in range(V)
                    if fw[s][v] >= 0 and not (
                        f_chunk[s] == v and not f_admit[s]
                    )
                }
                occ_b = {
                    (s, v) for s in range(pp) for v in range(V)
                    if bw[s][v] >= 0 and b_chunk[s] != v
                }
                sends_f: set = set()
                sends_b: set = set()
                stable = True
                for s in range(pp):
                    if f_chunk[s] >= 0:
                        g = g_of(s, f_chunk[s])
                        if g + 1 < pp * V:
                            dst = ((g + 1) % pp, (g + 1) // pp)
                            bad = dst in occ_f or dst in sends_f
                            if not bad:
                                sends_f.add(dst)
                        else:
                            # final stage: head dh deposits into the LOCAL
                            # bwd wait slot (pp-1, V-1)
                            dst = (pp - 1, V - 1)
                            bad = dst in occ_b or dst in sends_b
                            if not bad:
                                sends_b.add(dst)
                        if bad:
                            f_pick[s] += 1
                            stable = False
                    if b_chunk[s] >= 0:
                        g = g_of(s, b_chunk[s])
                        if g > 0:
                            dst = ((g - 1) % pp, (g - 1) // pp)
                            if dst in occ_b or dst in sends_b:
                                b_pick[s] += 1
                                stable = False
                            else:
                                sends_b.add(dst)
                if stable:
                    break
            else:
                raise AssertionError(
                    f"interleaved 1F1B constraint propagation did not "
                    f"stabilize at rotation {t} (M={M}, V={V}, pp={pp})"
                )

            if all(c < 0 for c in f_chunk) and all(c < 0 for c in b_chunk):
                raise AssertionError(
                    f"interleaved 1F1B planner deadlocked at rotation {t} "
                    f"(M={M}, V={V}, pp={pp}, cap={cap})"
                )

            # -- phase 3: commit state ------------------------------------
            for s in range(pp):
                if f_chunk[s] >= 0:
                    v, m = f_chunk[s], f_mb[s]
                    if f_admit[s]:
                        next_fresh += 1
                        in_flight += 1
                    else:
                        fw[s][v] = -1
                    g = g_of(s, v)
                    done_f.add((m, g))
                    fwd_t[(s, v, m)] = t
                    if g == pp * V - 1:
                        f_final[s] = 1
                        head_mb = m
                if b_chunk[s] >= 0:
                    v, m = b_chunk[s], b_mb[s]
                    bw[s][v] = -1
                    g = g_of(s, v)
                    done_b.add((m, g))
                    delay = t - fwd_t.pop((s, v, m))
                    max_delay = max(max_delay, delay)
                    b_read_slot[s] = -2  # filled once D is known (below)
                    if g == 0:
                        b_first[s] = 1
                        in_flight -= 1

            # -- phase 4: land sends (they arrive NEXT rotation's inboxes;
            #    the wait-slot state updates now, the routing tables tell
            #    the receiving lane which slot its inbox feeds) ------------
            for s in range(pp):
                if f_chunk[s] >= 0:
                    g = g_of(s, f_chunk[s])
                    if g + 1 < pp * V:
                        ds, dv = (g + 1) % pp, (g + 1) // pp
                        fw[ds][dv] = f_mb[s]
                        recv_f[ds] = dv
                    else:
                        bw[pp - 1][V - 1] = f_mb[s]
                if b_chunk[s] >= 0:
                    g = g_of(s, b_chunk[s])
                    if g > 0:
                        ds, dv = (g - 1) % pp, (g - 1) // pp
                        bw[ds][dv] = b_mb[s]
                        recv_b[ds] = dv

            # step t's recv tables describe rotation t-1's sends (the
            # inbox contents at the START of t)
            steps.append(InterleavedStep(
                f_chunk, f_mb, f_admit, f_final, b_chunk, b_mb, b_first,
                b_read_slot, prev_recv_f, prev_recv_b, head_mb,
            ))
            prev_recv_f, prev_recv_b = recv_f, recv_b
            t += 1

        if any(v >= 0 for v in prev_recv_f) or any(v >= 0 for v in prev_recv_b):
            raise AssertionError(
                "interleaved 1F1B plan ends with undelivered sends"
            )
        D = max_delay + 1
        # second pass: fill b_read_slot = (fwd rotation) % D
        fwd_rot = {}
        for ti, st in enumerate(steps):
            for s in range(pp):
                if st.f_chunk[s] >= 0:
                    fwd_rot[(s, st.f_chunk[s], st.f_mb[s])] = ti
            for s in range(pp):
                if st.b_chunk[s] >= 0:
                    key = (s, st.b_chunk[s], st.b_mb[s])
                    st.b_read_slot[s] = fwd_rot.pop(key) % D

        if len(done_f) != total or len(done_b) != total:
            raise AssertionError("interleaved 1F1B plan incomplete")
        object.__setattr__(self, "steps_", steps)
        object.__setattr__(self, "stash_depth", D)

    @property
    def num_rotations(self) -> int:
        return len(self.steps_)

    @property
    def active_lane_rotations(self) -> int:
        # fwd + bwd lane-rotations
        return 2 * self.num_microbatches * self.pp_size * self.num_model_chunks

    @property
    def idle_lane_rotations(self) -> int:
        # each rotation offers one fwd and one bwd slot per lane
        return 2 * self.num_rotations * self.pp_size - self.active_lane_rotations
