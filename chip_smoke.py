#!/usr/bin/env python3
"""Drive the torch port (diffdart_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one line each; any failure raises and exits nonzero, and nothing
falls back to the CPU or to the plain version:
  1. device   -- the card's name and power limit (nvidia-smi), torch/CUDA.
  2. build    -- nvcc builds every kernel source of this checkout
                 (ops/csrc/fused_step.cu, ops/csrc/jacobi_sweeps.cu), and
                 the host build of the sweeps (g++, for phase 12), one
                 process each, started together (each wrapper module's
                 _load, on its own thread); ptxas's registers and stack of
                 the step kernel and of the VJP kernel, per dtype; the step
                 kernel's shared memory per env (one warp, one block) at
                 the half-cheetah's D and nv, and its resident warps per SM
                 (cudaOccupancyMaxActiveBlocksPerMultiprocessor).
  3. f64      -- half-cheetah, B = 4096: 20 steps of kernel vs plain
                 version, re-synced to the plain version after each step;
                 q atol 1e-8, v atol 1e-7.
  4. f32      -- one step from the same inputs in float32: no non-finite
                 output, and >= 99% of envs within q 1e-4, v 5e-2 (the
                 Woodbury polish amplifies rounding by ~eps/cfm, ~1e-1 at
                 cfm = 1e-6 in float32, so rare active-set flips are allowed).
  5. main     -- rollout_fast on the half-cheetah, B = 4096, T = 50,
                 tau = 0.1 N(0,1), float32 (the benchmark config of the JAX
                 package's bench.py): the launch count over that run must be
                 T; the final state finite with a plausible torso height.
                 Then the kernel, the plain version and the rollout are
                 timed with CUDA events: the step kernel's device ms per
                 launch from its bare C launcher (step_device_ms), beside
                 the launch that stops after the front end (lane 0's serial
                 stage, before the warp's LCP solve).
  6. reference -- the same rollout in float64 at B = 256 through the kernel
                 and through the plain version: >= 99% of envs within
                 q 1e-6, v 1e-4 at the end of the 50 steps.
  7. grad64   -- the VJP kernel (reverse mode on a tape, one thread per
                 env), half-cheetah, B = 4096, one step in float64 with
                 (q, v, tau, gq, gv) from a numpy seed, against
                 torch.autograd.grad through the plain version: every env
                 finite, >= 99% of envs within rtol 1e-6 plus atol 1e-8 times
                 each of dq, dv, dtau's largest magnitude, and the tape's
                 primal (the serial solve) equal to kernel 1's output (the
                 warp's solve) bit for bit on all 4,096 envs. The tape's node count per
                 env, its bytes per env and per launch.
  8. grad32   -- the same step in float32 against reverse-mode autograd of
                 the plain float32 step (the kernel's own mode, on the same
                 primal): finite, a median env error of at most 1e-4 and
                 >= 90% of envs within 1e-2. The loose share is the eps/cfm
                 amplification of the Woodbury pass (0.12 at float32's eps and
                 cfm = 1e-6): where two codes round an adjoint differently,
                 an env's error is amplified that far. Forward-mode AD of the
                 plain float32 step is printed beside it; it cannot be held to
                 either (forward- and reverse-mode sums run in other orders).
                 The tape's float32 primal equals kernel 1's output bit for
                 bit on all 4,096 envs.
                 Tolerances and their reasons: diffdart_tpu_torch/ops/vjp_check.py.
  9. bptt     -- the main path of training: rollout_fast on the half-cheetah,
                 B = 4096, T = 50, tau = 0.1 N(0,1), float32, with taus that
                 require grad, the loss of the JAX package's bench.py
                 (mean(q_T[:, 1]^2) + 1e-4 mean(tau^2)), then backward():
                 50 launches of each kernel, a finite dtau whose part through
                 the kernels (dtau less the regulariser's own gradient) is
                 non-zero on >= 99% of envs; then loss + backward is timed
                 five times with CUDA events (median, min, max; fwd+grad
                 env-steps/s of the median); none of the T VJP launches
                 solves the LCP again (VJP_KERNEL.self_solved stays 0: each
                 takes the solution its step's forward launch saved). The
                 VJP kernel's ms per launch is its device time (its C
                 launcher called back to back on prepared pointers, see
                 vjp_device_ms) at kernel 1's saved solution, as the BPTT
                 launches it, with the device times of its counting launch
                 and of its recording without the sweep; the same three
                 solving the LCP themselves (the serial solve, as every
                 launch did before the forward saved its solution) beside
                 them; the wrapper's host time per call is printed beside
                 it.
 10. bptt-reference -- float64, B = 256, T = 10: the gradient of
                 mean(q_T[:, 1]^2) alone (all of it through the kernels)
                 against the same through the plain version, >= 99% of envs
                 within rtol 1e-5 plus atol 1e-8 of its largest magnitude (10
                 contact steps already amplify the rounding of the gradient;
                 50 amplify it past any tolerance).
The vmap stack (sim/step.py, sim/batched.py; the sweep kernel of
ops/csrc/jacobi_sweeps.cu, which replaces both Pallas sweep kernels):
 11. build    -- the sweep kernel's ptxas line (built in phase 2), and per
                 dtype at the half-cheetah's D its shared memory per warp
                 (one warp per env), its path (register or direct), warps
                 per block and the warps per SM it gets
                 (ops/pallas_lcp.py::launch_config).
 12. sweeps64 / sweeps32 -- the sweep kernel against _jacobi on the card, on
                 the LCPs that prepare_constrained assembles at phase 3's
                 inputs (B = 4096, D = 42) and on their first 13 envs; the
                 limits of diffdart_tpu_torch/ops/sweep_check.py (float64
                 1e-12, float32 1e-4, relative to max(1, |lam|)); and
                 against its host build (host_sweeps, the same per-warp code
                 on the CPU, in the same dtype): equal bit for bit.
 13. vmap-step -- float64, B = 4096, lcp_pivot_iters = 0: the vmap step with
                 contact_solver='lowrank_pallas' against the fused step
                 kernel, 20 steps re-synced, q 1e-7 and v 1e-5 (the JAX
                 package's tile-vs-vmap tolerances) on >= 99% of envs; the
                 number of envs outside them (active-set flips) is printed.
 14. vmap-main -- sim/step.py::rollout with 'lowrank_pallas', half-cheetah,
                 B = 4096, T = 50, tau = 0.1 N(0,1), float32, standing start:
                 T launches of jacobi_sweeps_single, a finite final state
                 with a plausible torso height; timed with CUDA events. The
                 sweep kernel's ms per launch is its device time (the C
                 launcher called back to back on prepared pointers, see
                 sweep_device_ms): cold (launches rotating over 4 copies of
                 its inputs, 129 MB in float32, past the 50 MB L2) and warm
                 (one set, which stays in the L2), the same with iters = 0
                 (the copy of A and the row scales alone), and float64 cold
                 and warm, beside their byte bounds (sweep_readings); the
                 wrapper's host time per call is printed beside it.
 15. batched  -- the same rollout through step_batched: T launches of
                 jacobi_sweeps; one float64 step matches the vmap step
                 within phase 13's tolerances on >= 99% of envs; timed, with
                 phase 14's sweep readings taken again.
 16. vmap-bptt -- rollout_fast with model.mass requiring grad: it warns and
                 falls back to the vmap stack (rollout_checkpointed, which
                 keeps each step's LCP impulse); the bench loss of phase 9
                 and backward(): T sweep launches (the forward solves; the
                 backward recomputes each step with its impulse and runs no
                 sweeps), dtau less the regulariser's gradient non-zero on
                 >= 99% of envs, d loss / d mass finite and non-zero; peak
                 memory and fwd+grad env-steps/s printed.
 17. vmap-reference -- float64, B = 256, T = 10: the gradient of
                 mean(q_T[:, 1]^2) over the converged envs (natural-map
                 residual below 1e-8 at every step) with respect to tau and
                 mass, through the kernel ('lowrank_pallas') against the
                 plain sweeps ('lowrank'), within ops/vjp_check.py's limits.
 18. jacobians -- neural/jacobians.py::timestep_jacobians on the
                 half-cheetah, B = 4096, float32, 'lowrank_pallas', at the
                 state after 10 steps of phase 14's rollout started 0.15
                 lower (4 active contacts per env): all seven blocks, finite on >= 99% of envs; the
                 sweep launches per call (one per forward solve: 1); timed
                 with CUDA events (median of 5) as env-Jacobian-sets/s.
                 Float64, B = 256, on the converged envs (natural-map
                 residual below 1e-8): through the kernel against the plain
                 sweeps ('lowrank') within ops/vjp_check.py's limits; on 8
                 of them against central differences (eps 1e-5; 1e-6 is
                 printed, where the solve's own rounding over 2 eps reaches
                 ~1e-3) within atol 3e-4 (tests/test_neural.py's contact
                 tolerance); and backprop's result equal to J^T g from the
                 Jacobians within 1e-8 of its largest magnitude.
 19. dense-lcp -- cube_drop, B = 4096, float32, contact_solver 'pgs' then
                 'jacobi' (ops/lcp.py::boxed_lcp, plain PyTorch), 200 steps
                 from rest 2-20 mm above the ground: every resting height
                 within 1 mm of the half-extent, the gradient of the final
                 pose with respect to the initial velocity finite and
                 non-zero (rollout_checkpointed), no sweep-kernel launch;
                 ms per step timed.
 20. bilateral -- the ball-pinned pendulum and the welded pair of
                 tests/test_bilateral.py, B = 4096, 200 steps with
                 'lowrank_pallas': the anchor stays within 2e-3 of the
                 origin, the welded pair's relative pose within 5e-3; the
                 first step's LCP (bilateral rows: lo = -inf, hi = +inf)
                 through the sweep kernel against _jacobi within
                 ops/sweep_check.py's limits and against the host build bit
                 for bit; a chain of the five joint types of the last slice
                 (SCREW, UNIVERSAL, EULER, TRANSLATIONAL, TRANSLATIONAL2D),
                 100 steps in float64 on the card against the port on the
                 CPU, q and v within 1e-9.
The Atlas-class humanoid (models/humanoid.py: URDF, convex-mesh feet,
pelvis and torso, nv = 30, 33 contact slots) and the catapult:
 21. humanoid-build -- both models built on the card: nv, nq, contact slots,
                 LCP rows D with all slots (147) and with contact_budget=12
                 (84), the hulls' vertex and face counts; the sweep kernel's
                 launch_config at each D in both dtypes (the direct path,
                 bytes per warp, warps per SM; D within max_rows); every
                 field of the humanoid on the card, hull buffers included,
                 equal bit for bit to the same model built on the CPU.
 22. humanoid-sweeps -- the LCPs prepare_constrained assembles at a seeded
                 perturbed standing state (the root 5 mm low, joints +-0.05
                 rad, v ~ 0.1 N(0,1)): float32 B = 2048 with the budget
                 (D = 84), float32 and float64 B = 256 with every slot
                 (D = 147); the kernel against _jacobi within
                 ops/sweep_check.py's limits and against its host build bit
                 for bit; cold and warm device ms (sweep_device_ms) beside
                 sweep_bound, and _jacobi's ms. One float64 step_batched call
                 (B = 256): one jacobi_sweeps launch, >= 99% of envs within
                 phase 13's tolerances of the vmap step.
 23. humanoid-main -- the JAX package's Atlas workload (its bench.py
                 sections 2-3), float32, 'lowrank_pallas': the forward
                 rollout, B = 256, T = 10, zero tau, every slot: T launches
                 of jacobi_sweeps_single, no fused-step launch, a finite
                 final state with the root above 0.2 m; the BPTT,
                 rollout_checkpointed with contact_budget=12, B = 2048,
                 T = 20, tau = 0.5 N(0,1) (with zero tau the gradient is
                 zero by symmetry), loss mean(q_T[:, 2]^2) + 1e-4 mean(tau^2):
                 T sweep launches, dtau finite and, less the regulariser's
                 own gradient, non-zero on >= 99% of envs, peak memory; each
                 timed with CUDA events, median of 5, as fwd and fwd+grad
                 env-steps/s; one vmap step of each config under
                 torch.profiler: kernels per step, device busy ms, idle share.
 24. humanoid-reference -- float64, B = 64, T = 5, budget 12, standing with
                 tau = 0.5 N(0,1): the gradient of mean(q_T[:, 2]^2) over the
                 converged envs (natural-map residual below 1e-8 at every
                 step), through the kernel (T launches) against the plain
                 sweeps ('lowrank'), within ops/vjp_check.py's limits;
                 timestep_jacobians at B = 256, float32, standing: all seven
                 blocks finite on >= 99% of envs, one sweep launch per call,
                 median of 5 as env-Jacobian-sets/s; the catapult, B = 256,
                 100 float32 steps through the kernel (100 launches), finite.
Convex and hybrid models, the pair budget, the dynamics API and trajectory
optimization (each model outside the fused kernel reaches the vmap stack
through rollout_fast's warning, which names the reason, or directly
through sim/step.py). At each new
model's states the sweep kernel is held against _jacobi on the LCPs that
prepare_constrained assembles, in the solve's dtype, within
ops/sweep_check.py's limits ("[sweeps]" lines: the octahedron and the
sphere field at their timed B in float32, the budgeted worm, the
catapult's and the jump-worm's float64 islands):
 25. convex-hybrid -- tests/test_tilestep_hybrid.py's octahedron hull on a
                 plane on the vmap stack (sim/step.py::rollout; the
                 fused path takes it in phase 29), B = 4096, T = 10,
                 float32, 'lowrank_pallas': T sweep launches, no fused-step
                 launch, timed (median of 3); one step_batched call (one
                 batched launch); float64, 16 envs, 10 re-synced steps: the
                 card's vmap step against the CPU's plain fused step (its
                 convex slots) within q 1e-7, v 1e-5. The 2-link
                 worm with contact_budget=3 (the hybrid LCP mode):
                 rollout_tiled's hybrid branch on the card, B = 256, T = 5,
                 float64, no fused-step launch, against the same on the CPU
                 (q 1e-7, v 1e-5 on >= 99% of envs), timed (the first call,
                 then a median of 3); rollout_fast on the
                 budgeted worm names the hybrid reason and makes T sweep
                 launches.
 26. pair-budget -- the sphere field (16 spheres: 16 sphere-plane and 120
                 sphere-sphere pairs), pair_budget=8 (16 slots), B = 1024,
                 T = 20, float32, 'lowrank_pallas': T sweep launches; ms per
                 step, env-steps/s (median of 3), kernels per step and idle
                 share (torch.profiler); one step_batched launch; float64,
                 B = 8, T = 30, sparse (at most 8 plane pairs and one sphere
                 pair touch): the budgeted trajectory equal to the full
                 plan's (408 rows, plain sweeps) within 1e-9.
 27. dynamics-api -- the humanoid, B = 256, float64: forward_dynamics and
                 inverse_dynamics on the card against the CPU (1e-10 of the
                 largest magnitude), inverse(forward(tau)) = tau within 1e-8.
 28. trajectory -- the catapult's BPTT at examples/catapult_shooting.py's
                 configuration (scripts/torch_catapult_shooting.py: T = 150,
                 float32 + float64 island, Adam 0.5): 5 iterations (of 200),
                 the loss falling, 150 sweep launches per iteration, ms per
                 iteration (median); its float64 gradient at the warm start
                 on the card against the CPU's within 1e-6; the jump-worm's
                 iLQR at examples/jumpworm_ilqr.py's configuration
                 (scripts/torch_jumpworm_ilqr.py): 2 iterations (of 20), ms
                 per iteration and the share in the batched linearization;
                 one MPC solve of examples/mpc_cartpole.py's configuration,
                 timed.
Slice 10: convex slots on the fused kernels, and the loaders, the World,
IK, recordings and the native pivot oracle:
 29. convex-fused -- the octahedron (4 hull slots, D = 12) on kernels 1 and
                 2, B = 4096: float64, 20 steps of kernel 1 against the plain
                 version, re-synced, q 1e-8, v 1e-7; float32, one step,
                 >= 99% of envs within q 1e-4, v 5e-2; rollout_fast, T = 10,
                 float32: T launches of kernel 1, no sweep launch and no
                 warning, timed (median of 5) beside phase 25's vmap
                 rollout of the same model; its BPTT: T step and T VJP
                 launches; rollout_tiled on the card refuses two models over
                 a cap (the 17-body chain; three 32-vertex hulls, 96 over the
                 vertex pool's 64) with NotImplementedError naming the cap,
                 and launches nothing; the VJP in float64 against autograd
                 through the plain version at ops/vjp_check.py's limits, its
                 primal equal to kernel 1's output bit for bit; each
                 kernel's device ms per launch beside its bound
                 (ops_per_env_step / ops_per_env_vjp of the octahedron) and
                 the plain version's ms; tape nodes per env.
 30. loaders-world -- the port's scene files (diffdart_tpu_torch/assets/
                 scenes: SKEL, SDF, VSK, URDF) through io.load_into_builder
                 into a World on the card, float64, 50 steps from seeded
                 velocities, equal to the same World on the CPU within
                 1e-10; the three stored goldens (tests/goldens) with
                 B = 256 copies of each start on the card, every env held
                 to the golden at tests/test_goldens.py's tolerances (where
                 the card leaves cube_drop's chaotic bounce, the step and
                 the size are printed and one step from the CPU port's state
                 there is held to the CPU within 1e-9); solve_ik and
                 HierarchicalIK, B = 64, float64, card vs CPU (solve_ik
                 1e-8; HierarchicalIK, chaotic in a few envs, one iteration
                 within 1e-10 on every env, and after 80 iterations q and
                 both levels' errors within 1e-10 on the envs that a second
                 CPU solve from a start moved by 1e-15 marks stable, >= 85%
                 of them); the native Dantzig pivot solver built with g++ on
                 the machine, the exact oracle of the 'lowrank_pallas'
                 solves (one sweep launch) at 256 cube_drop contact states:
                 the pivot solve exact (status 0) on >= 90% of them, and on
                 every such env the velocity impulse M^-1 J^T lam within
                 1e-6 of the pivot solution's.
Slice 11: data-parallel BPTT on torch.distributed, profiling, checkpoints,
the viewer and the bridge (the last modules of the port):
 31. parallel -- the half-cheetah, B = 4096, T = 50, float32, a shared
                 control tape (T, nv) as the replicated params plus per-env
                 noise 0.1 N(0,1) in the batch, per-env loss q_T[:, 1]^2 +
                 1e-4 mean(tau^2): (a) make_mesh(1) on cuda:0, shard_batch,
                 data_parallel_grad: T launches of each fused kernel, loss
                 and gradient equal to the same loss's plain backward() bit
                 for bit (B a power of two: the division is exact); (b) the
                 same in a one-rank NCCL group (init_distributed on
                 127.0.0.1, backend nccl: the all-reduce on the card), equal
                 to (a) bit for bit, the data-parallel step and the bare BPTT
                 timed (median of 5) and one all-reduce of the packed sums;
                 (c) two processes on the one card (this script with
                 --dp-child), backend gloo (NCCL refuses two ranks on one
                 device), each feeding 2,048 envs (local_env_slice): T
                 launches of each kernel per process, the loss within rtol
                 1e-5 and the gradient within 1e-5 max|g| of (a), the two
                 equal bit for bit; each child killed at 240 s.
 32. utils    -- device_trace around one rollout_fast (T = 50) inside
                 named_scope, in this process after phases 1-31: every
                 kernel launch the trace records has its kernel event
                 (device_trace raises otherwise), T of them the step
                 kernel's by name, and the scope; a checkpoint resume of
                 phase 31's data-parallel Adam loop (3 steps, save,
                 restore on the card, 2 steps) equal to 5 straight steps
                 bit for bit.
 33. viewer   -- trajectory_frames of env 0 of a card rollout of the
                 half-cheetah (T = 50, one kernel-1 launch per step) against
                 the same q on the CPU within one unit in the fifth place
                 (both round to 5 places); GUIWebsocketServer on
                 127.0.0.1, port 0, streams the scene and T frames from
                 card states to a raw-socket client in this process, which
                 parses them.
 34. bridge   -- torch_bridge.timestep on cube_drop with
                 contact_solver='lowrank_pallas', float64, 20 steps landing
                 on the cube's contacts: one jacobi_sweeps_single launch
                 per step, q and v within 1e-9 of the CPU port's, the
                 chain's gradient within 1e-8 relative.
Then one JSON line with the kernels' numbers (jacobi_sweeps_single also
under "humanoid": its launches in phases 23-24 and its readings at each
humanoid D beside their bounds, and under "slice9" its launches in phases
25-28 and the max_abs_err of each "[sweeps]" comparison, and its launch in
phase 30's oracle check; jacobi_sweeps its step_batched launches of phases
22, 25 and 26; fused_step and fused_step_vjp the octahedron's numbers of
phase 29 under "convex", and phase 31's launches per process and device
share under "parallel"; jacobi_sweeps_single phase 34's launches under
"launches_bridge"),
the card line, and the result line {"ok": true, "device": {...}}.
"""
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12  # H100 SXM
F32_OPS_PER_S = 67e12  # H100 SXM, float32 outside the tensor cores
F64_OPS_PER_S = 34e12  # H100 SXM, float64 outside the tensor cores
B, T = 4096, 50


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def cuda_ms(fn, reps):
    """Mean device time of fn() in ms over `reps` calls, after one warm-up."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def host_ms(fn, reps):
    """Mean host time of issuing fn() in ms over `reps` calls, after one
    warm-up; the device work they queue is waited for only afterwards."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    out = 1e3 * (time.perf_counter() - t0) / reps
    torch.cuda.synchronize()
    return out


def bare_ms(fn, args, reps):
    """(device ms, host ms) per launch of a kernel's C launcher `fn` called
    directly on prepared pointers `args`: `reps` launches back to back
    between CUDA events, so none of a wrapper's checks sits between two
    launches. While the host ms (the time to issue one launch) is below the
    device ms, the card never waits for the host and the events time the
    kernel alone. `args` may be a list of argument tuples: the launches
    then take them in turn."""
    sets = args if isinstance(args, list) else [args]
    check(all(fn(*a) == 0 for a in sets), f"{fn.__name__} launch failed")
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    t0 = time.perf_counter()
    errs = [fn(*sets[i % len(sets)]) for i in range(reps)]
    host = 1e3 * (time.perf_counter() - t0) / reps
    end.record()
    torch.cuda.synchronize()
    check(not any(errs), f"{fn.__name__} launch failed")
    return start.elapsed_time(end) / reps, host


def step_device_ms(lib, desc, D, q, v, tau, front_only=False, reps=50, sized=None, solution=False):
    """(device ms, host ms, (q', v', sol)) per launch of the step kernel
    through its C launcher (bare_ms). front_only: the launch that stops
    after the front end (v' is then v*, q' unwritten). D and `sized`
    (default: v's nv) size the shared memory per env: at or above the
    model's D and nv. solution: the launch that also writes each env's
    detached LCP solution into sol, (B, D + 1), as the BPTT's forward does
    (else sol is None)."""
    fn = lib.fused_step_f32 if q.dtype == torch.float32 else lib.fused_step_f64
    qo, vo = torch.empty_like(q), torch.empty_like(v)
    sol = torch.empty((q.shape[1], D + 1), dtype=q.dtype, device=q.device) if solution else None
    args = (*(x.data_ptr() for x in (*desc, q, v, tau, qo, vo)),
            None if sol is None else sol.data_ptr(), q.shape[1], D,
            v.shape[0] if sized is None else sized, int(front_only),
            torch.cuda.current_stream().cuda_stream)
    ms, host = bare_ms(fn, args, reps)
    return ms, host, (qo, vo, sol)


def sweep_device_ms(lib, A, b, lo, hi, mu, fidx, iters, reps=200, copies=1):
    """(device ms, host ms) per launch of the sweep kernel (bare_ms). With
    copies > 1 the launches rotate over that many copies of the inputs and
    outputs: each launch then finds its inputs evicted from the L2 by the
    others' (cold), where one set stays in the 50 MB L2 (warm)."""
    fn = lib.jacobi_sweeps_f32 if A.dtype == torch.float32 else lib.jacobi_sweeps_f64
    stream = torch.cuda.current_stream().cuda_stream
    sets = []
    for _ in range(copies):
        xs = [x.clone().contiguous() for x in (A, b, lo, hi, mu, fidx)] + [torch.empty_like(b)]
        sets.append((xs, (*(x.data_ptr() for x in xs), b.shape[0], b.shape[1], iters, stream)))
    return bare_ms(fn, [a for _, a in sets], reps)


def sweep_bound(B_, D_, iters, dtype):
    """(bound ms, bytes ms, operations ms) of the sweeps: each input read
    once (A, b, lo, hi, mu, fidx), lam written once; per env 2 D^2 + 5 D
    operations for the row scales, and per iteration one matvec (2 D^2:
    each row's dot product is taken in one of the two half-sweeps) and
    10 D per half-sweep (step, bounds, clip, select). Float64 at the H100
    SXM's 34 TFLOP/s outside the tensor cores (NVIDIA's data sheet)."""
    elem = torch.finfo(dtype).bits // 8
    nbytes = (B_ * D_ * D_ + 5 * B_ * D_) * elem + D_ * 8
    ops = B_ * (2 * D_ * D_ + 5 * D_ + iters * (2 * D_ * D_ + 20 * D_))
    t_bytes = 1e3 * nbytes / HBM_BYTES_PER_S
    t_ops = 1e3 * ops / (F32_OPS_PER_S if elem == 4 else F64_OPS_PER_S)
    return max(t_bytes, t_ops), t_bytes, t_ops


def sweep_readings(lib, lcp32, lcp64, iters):
    """The sweep kernel's device ms per launch on the half-cheetah's LCPs
    (sweep_device_ms): float32 warm and cold, iters = 0 (the copy of A and
    the row scales alone) warm and cold, float64 warm and cold; and the
    host ms to issue one launch, warm and cold (float32)."""
    a32 = (lcp32.A, lcp32.b, lcp32.lo, lcp32.hi, lcp32.mu, lcp32.fidx)
    a64 = (lcp64.A, lcp64.b, lcp64.lo, lcp64.hi, lcp64.mu, lcp64.fidx)
    out = {}
    out["warm"], out["issue"] = sweep_device_ms(lib, *a32, iters)
    out["cold"], out["issue_cold"] = sweep_device_ms(lib, *a32, iters, copies=4)
    out["warm0"] = sweep_device_ms(lib, *a32, 0)[0]
    out["cold0"] = sweep_device_ms(lib, *a32, 0, copies=4)[0]
    out["warm64"] = sweep_device_ms(lib, *a64, iters)[0]
    out["cold64"] = sweep_device_ms(lib, *a64, iters, copies=4)[0]
    return out


def sweep_line(r, bound32, bound64):
    """The text of sweep_readings' numbers beside their bounds."""
    return (f"float32 cold {r['cold']:.4f} ms (launches rotating over 4 copies of the inputs, past "
            f"the 50 MB L2), warm {r['warm']:.4f} ms (one set, L2-resident: it may read below the "
            f"HBM bound), bound {bound32:.6f} ms (bytes), cold {r['cold'] / bound32:.2f}x it; "
            f"iters = 0 (the copy of A and the row scales alone) cold {r['cold0']:.4f}, warm "
            f"{r['warm0']:.4f} ms; float64 cold {r['cold64']:.4f}, warm {r['warm64']:.4f} ms, bound "
            f"{bound64:.6f} ms (bytes), cold {r['cold64'] / bound64:.2f}x it; issuing one launch "
            f"{r['issue']:.4f} ms (cold set {r['issue_cold']:.4f}) on the host")


def vjp_device_ms(lib, desc, q, v, tau, gq, gv, cap, reps=20, part="whole", solution=None):
    """(device ms, host ms) per launch of the VJP kernel (bare_ms), with a
    tape of `cap` nodes per env allocated once. part='whole' is the whole
    launch; 'record' records the tape and stops (dq null: no sweep);
    'count' is the counting launch (no tape: the recording's arithmetic).
    solution: the forward's detached LCP solution (step_device_ms with
    solution=True), which the BPTT's launches take; None: the VJP solves
    the LCP itself."""
    from diffdart_tpu_torch.ops.fused_step import tape_bytes

    fn = lib.fused_step_vjp_f32 if q.dtype == torch.float32 else lib.fused_step_vjp_f64
    outs = [torch.empty_like(x) for x in (q, v, tau)]
    if part != "whole":
        outs[0] = None
    tape = torch.empty(tape_bytes(q.dtype, cap, q.shape[1]), dtype=torch.uint8, device=q.device)
    status = torch.zeros(2, dtype=torch.int32, device=q.device)
    sol, sol_w = (None, 0) if solution is None else (solution.data_ptr(), solution.shape[1])
    args = (*(x.data_ptr() for x in (*desc, q, v, tau)), sol, *(x.data_ptr() for x in (gq, gv)),
            *(None if x is None else x.data_ptr() for x in outs), None, None,
            None if part == "count" else tape.data_ptr(), status.data_ptr(), q.shape[1], cap, sol_w,
            torch.cuda.current_stream().cuda_stream)
    out = bare_ms(fn, args, reps)
    check(int(status[1]) == 0, "the VJP kernel's tape overflowed")
    return out


def ptxas_lines(lib):
    """{kernel name: "N registers, M bytes stack"} from nvcc's ptxas report
    (-Xptxas -v), one entry per kernel and dtype."""
    names = {"fused_step_kernelIf": "fused_step<float>", "fused_step_kernelId": "fused_step<double>",
             "fused_step_vjp_kernelIf": "fused_step_vjp<float>",
             "fused_step_vjp_kernelId": "fused_step_vjp<double>",
             "jacobi_sweeps_kernelIf": "jacobi_sweeps<float>",
             "jacobi_sweeps_kernelId": "jacobi_sweeps<double>"}
    out, cur, entry, props, stack = {}, None, None, None, ""
    for ln in lib.build_log.splitlines():
        if "Compiling entry function" in ln:
            cur = next((v for k, v in names.items() if k in ln), None)
            entry = ln.split("'")[1] if "'" in ln else None
        elif "Function properties for" in ln:
            props = ln.split("Function properties for")[1].strip()
        elif "stack frame" in ln and props == entry:  # the kernel's own, not a callee's
            stack = ln.strip().split(",")[0]
        elif "registers" in ln and cur is not None:
            regs = ln.split("Used")[1].split(",")[0].strip()
            out[cur] = f"{regs}, {stack}"
    return out


_COUNTED = {
    "add", "radd", "sub", "rsub", "mul", "rmul", "truediv", "rtruediv", "div", "neg",
    "maximum", "minimum", "abs", "sqrt", "rsqrt", "sin", "cos", "where", "gt", "ge", "lt",
    "le", "eq", "ne", "logical_and", "logical_or", "logical_not", "invert", "isfinite",
}


def ops_per_env_vjp(model_cpu, q, v, tau):
    """Elementwise operations of the plain version's VJP per env: its forward
    with grad enabled (which adds the probe and gradient passes) plus its
    autograd backward, seen at the aten level by a TorchDispatchMode, counted
    on the CPU at B = 1."""
    from torch.utils._python_dispatch import TorchDispatchMode

    from diffdart_tpu_torch.sim.tilestep import build_tile_step

    counted = _COUNTED | {"bitwise_not", "masked_fill", "sgn", "pow", "reciprocal"}

    class Count(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if func.overloadpacket.__name__.strip("_") in counted:
                Count.n += 1
            return func(*args, **(kwargs or {}))

    step = build_tile_step(model_cpu)
    xs = [x.clone().requires_grad_(True) for x in (q, v, tau)]
    with Count():
        out = step(*xs)
        torch.autograd.grad(out, xs, [torch.ones_like(o) for o in out])
    return Count.n


def ops_per_env_step(model_cpu, q, v, tau):
    """Elementwise operations the plain version performs per env in one
    forward step (structural zeros folded away, as the work the step needs),
    counted on the CPU at B = 1."""
    from torch.overrides import TorchFunctionMode

    from diffdart_tpu_torch.sim.tilestep import build_tile_step

    class Count(TorchFunctionMode):
        n = 0

        def __torch_function__(self, func, types, args=(), kwargs=None):
            if getattr(func, "__name__", "").strip("_") in _COUNTED:
                Count.n += 1
            return func(*args, **(kwargs or {}))

    step = build_tile_step(model_cpu)
    with torch.no_grad(), Count():
        step(q, v, tau)
    return Count.n


def _script(name):
    """The module scripts/<name>.py of this checkout, loaded by its path."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        name, os.path.join(os.path.dirname(os.path.abspath(__file__)), "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def median_ms(fn, runs=5, warm=True):
    """(median, min, max) ms of fn() over `runs` calls, each timed with CUDA
    events, after one warm-up call (warm=False: fn has just run)."""
    if warm:
        fn()
    torch.cuda.synchronize()
    r = []
    for _ in range(runs):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        r.append(start.elapsed_time(end))
    r.sort()
    return r[len(r) // 2], r[0], r[-1]


def humanoid_state(m, B_, seed):
    """A seeded perturbed standing state of the humanoid on the card: the
    root 5 mm low, the joints +-0.05 rad, v ~ 0.1 N(0,1)."""
    from diffdart_tpu_torch.dynamics.model import State
    from diffdart_tpu_torch.models import humanoid_init_q

    rng = np.random.RandomState(seed)
    q = np.tile(humanoid_init_q(m).cpu().numpy(), (B_, 1))
    q[:, 6] -= 0.005
    q[:, 7:] += 0.05 * (2 * rng.rand(B_, m.nq - 7) - 1)
    v = 0.1 * rng.randn(B_, m.nv)
    return State(q=torch.tensor(q, dtype=m.dtype, device="cuda"),
                 v=torch.tensor(v, dtype=m.dtype, device="cuda"))


def humanoid_phases(card, lib_sw, reset_counts):
    """Phases 21-24: the Atlas-class humanoid (and the catapult) on the
    card. Returns the sweep kernel's humanoid readings for the kernel line."""
    from diffdart_tpu_torch.collision.collide import max_contacts
    from diffdart_tpu_torch.constraints.assembly import static_fidx
    from diffdart_tpu_torch.dynamics.model import State, model_to_numpy
    from diffdart_tpu_torch.models import catapult, catapult_init_q, humanoid, humanoid_init_q
    from diffdart_tpu_torch.neural import timestep_jacobians
    from diffdart_tpu_torch.ops import fused_step as fs
    from diffdart_tpu_torch.ops import pallas_lcp as P
    from diffdart_tpu_torch.ops import sweep_check as sc
    from diffdart_tpu_torch.ops import vjp_check as vc
    from diffdart_tpu_torch.ops.lcp import _jacobi
    from diffdart_tpu_torch.sim import step as S
    from diffdart_tpu_torch.sim.batched import step_batched
    from diffdart_tpu_torch.sim.constrained import prepare_constrained, solver_diagnostics
    device_profile = _script("torch_vmap_timing").device_profile

    f32, f64 = torch.float32, torch.float64
    out = {}

    # ---- 21. humanoid-build ----
    mh = {dt: humanoid(dtype=dt, device="cuda") for dt in (f32, f64)}
    m = mh[f32]
    D_full, D_bud = len(static_fidx(m)), len(static_fidx(m.replace(contact_budget=12)))
    cat = catapult(dtype=f32, device="cuda")
    print(f"[humanoid-build] humanoid nv {m.nv}, nq {m.nq}, {m.nbody} bodies, {m.ngeom} geoms, "
          f"{len(m.col_pairs)} ground pairs, {max_contacts(m)} contact slots; D = {D_full} LCP rows, "
          f"{D_bud} with contact_budget=12; {len(m.hull_vcounts)} hulls (vertices {m.hull_vcounts}, "
          f"faces {m.hull_fcounts}, padded to {m.hull_verts.shape[1]} / {m.hull_face_n.shape[1]}); "
          f"catapult nv {cat.nv}, {max_contacts(cat)} slots, D = {len(static_fidx(cat))}")
    check((m.nv, m.nq, max_contacts(m), D_full, D_bud) == (30, 31, 33, 147, 84), "bad humanoid layout")
    check(len(m.hull_vcounts) == 4, "expected 4 hulls")
    cfgs = {}
    for dt in (f32, f64):
        for D_ in (D_bud, D_full):
            c = P.launch_config(dt, D_)
            cfgs[str(dt)[6:], D_] = c
            check(c["warps_per_sm"] > 0 and D_ <= P.max_rows(dt), f"the sweep kernel cannot take D = {D_}")
            check(not c["register_path"], f"D = {D_} should take the direct path")
    print("[humanoid-build] sweep kernel: " + "; ".join(
        f"{k[0]} D = {k[1]}: {'register' if c['register_path'] else 'direct'} path, "
        f"{c['warp_bytes']} bytes per warp, {c['warps_per_block']} warps per block, {c['warps_per_sm']} "
        f"warps per SM" for k, c in cfgs.items())
        + f"; row caps {P.max_rows(f32)} (float32), {P.max_rows(f64)} (float64)")
    same = True
    for dt in (f32, f64):
        on_card, on_cpu = model_to_numpy(mh[dt]), model_to_numpy(humanoid(dtype=dt, device="cpu"))
        for k, x in on_card.items():
            y = on_cpu[k]
            same &= bool(np.array_equal(x, y)) if isinstance(x, np.ndarray) else x == y
    print(f"[humanoid-build] every field, hull buffers included, on the card == the same model built "
          f"on the CPU bit for bit, both dtypes: {same}")
    check(same, "the humanoid built on the card differs from the CPU build")

    # ---- 22. humanoid-sweeps ----
    out["shapes"] = []
    it = m.contact_iters
    for dt, budget, Bh in ((f32, 12, 2048), (f32, 0, 256), (f64, 0, 256)):
        m_ = mh[dt].replace(contact_budget=budget)
        with torch.no_grad():
            lcp = prepare_constrained(m_, humanoid_state(m_, Bh, seed=7))[0]
        D_ = lcp.b.shape[-1]
        args = (lcp.A, lcp.b, lcp.lo, lcp.hi, lcp.mu)
        got = P.jacobi_sweeps_pallas_single(*args, lcp.fidx, it)
        want = _jacobi(*args, lcp.fidx, it)
        torch.cuda.synchronize()
        err, rel = sc.sweep_error(got, want)
        exact = bool(torch.equal(got.cpu(), P.host_sweeps(*args, lcp.fidx, it, dtype=dt)))
        with torch.no_grad():
            cold, issue = sweep_device_ms(lib_sw, *args, lcp.fidx, it, copies=4)
            warm, _ = sweep_device_ms(lib_sw, *args, lcp.fidx, it)
            plain = cuda_ms(lambda: _jacobi(*args, lcp.fidx, it), reps=5)
        bound, tb, to = sweep_bound(Bh, D_, it, dt)
        name = str(dt)[6:]
        print(f"[humanoid-sweeps] {name} B={Bh} D={D_} iters={it}: kernel vs _jacobi max |dlam| {err:.3e}, "
              f"max relative {rel:.3e} (limit {sc.REL_F64 if dt == f64 else sc.REL_F32:g}); == host build "
              f"bit for bit {exact}; on {card}: cold {cold:.4f} ms (4 rotating input copies), warm "
              f"{warm:.4f} ms, bound {bound:.6f} ms ({'operations' if to >= tb else 'bytes'}), cold "
              f"{cold / bound:.2f}x it; issuing one launch {issue:.4f} ms; plain _jacobi {plain:.4f} ms")
        check(sc.sweep_ok(got, want), f"humanoid sweeps: the kernel disagrees with _jacobi ({name}, D={D_})")
        check(exact, f"humanoid sweeps: the kernel differs from its host build ({name}, D={D_})")
        check(issue < cold, "the sweep kernel's timing waited on the host")
        out["shapes"].append({"B": Bh, "D": D_, "dtype": name, "max_abs_err": err, "ms": cold,
                              "warm_ms": warm, "plain_ms": plain, "bound_ms": bound,
                              "bound_by": "operations" if to >= tb else "bytes"})
    m64b = mh[f64].replace(lcp_pivot_iters=0)
    st_b = humanoid_state(m64b, 256, seed=8)
    tau_b = torch.zeros(256, m64b.nv, dtype=f64, device="cuda")
    with torch.no_grad():
        reset_counts()
        sb = step_batched(m64b, st_b, tau_b)
        torch.cuda.synchronize()
        out["launches_step_batched"] = P.KERNEL.launches
        sv = S.step(m64b, st_b, tau_b)
    dq, dv = (sb.q - sv.q).abs().amax(1), (sb.v - sv.v).abs().amax(1)
    share = ((dq <= 1e-7) & (dv <= 1e-5)).double().mean().item()
    print(f"[humanoid-sweeps] step_batched, f64 B=256 D={D_full}: {out['launches_step_batched']} "
          f"jacobi_sweeps launch; against the vmap step {100 * share:.2f}% of envs within q 1e-7, v 1e-5 "
          f"(max |dq| {dq.max().item():.3e}, |dv| {dv.max().item():.3e})")
    check(out["launches_step_batched"] == 1, "step_batched did not launch the batched sweep kernel once")
    check(share >= 0.99, "step_batched disagrees with the vmap step on the humanoid")

    # ---- 23. humanoid-main: forward rollout and BPTT through the kernel ----
    mp = m.replace(contact_solver="lowrank_pallas")
    Bf, Tf = 256, 10
    st_f = State(q=humanoid_init_q(mp).repeat(Bf, 1), v=torch.zeros(Bf, mp.nv, device="cuda"))
    taus_f = torch.zeros(Tf, Bf, mp.nv, device="cuda")
    with torch.no_grad():
        reset_counts()
        fin_f, _ = S.rollout(mp, st_f, taus_f)
        torch.cuda.synchronize()
        out["launches_rollout"] = P.KERNEL_SINGLE.launches
        fused_launches = fs.KERNEL.launches
    z = fin_f.q[:, 6]
    finite_f = bool(torch.isfinite(fin_f.q).all() and torch.isfinite(fin_f.v).all())
    print(f"[humanoid-main] rollout (vmap stack, lowrank_pallas) B={Bf} T={Tf} f32, zero tau, every slot "
          f"(D = {D_full}): {out['launches_rollout']} jacobi_sweeps_single launches, {fused_launches} "
          f"fused-step launches; root z min {z.min().item():.4f} max {z.max().item():.4f}; finite {finite_f}")
    check(out["launches_rollout"] == Tf, f"expected {Tf} sweep launches in the humanoid rollout")
    check(fused_launches == 0, "the fused step ran on the humanoid")
    check(finite_f and bool((z > 0.2).all()), "bad final state of the humanoid rollout")
    with torch.no_grad():
        roll = median_ms(lambda: S.rollout(mp, st_f, taus_f))
    mg = mp.replace(contact_budget=12)
    Bg, Tg = 2048, 20
    st_g = State(q=humanoid_init_q(mg).repeat(Bg, 1), v=torch.zeros(Bg, mg.nv, device="cuda"))
    # tau = 0.5 N(0,1): with zero tau the loss's gradient is zero by the
    # model's left-right symmetry (q[:, 2] is the root quaternion's y)
    taus_g = torch.tensor(0.5 * np.random.RandomState(9).randn(Tg, Bg, mg.nv), dtype=f32, device="cuda")

    def hbptt():
        x = taus_g.clone().requires_grad_(True)
        fin = S.rollout_checkpointed(mg, st_g, x)
        ((fin.q[:, 2] ** 2).mean() + 1e-4 * (x**2).mean()).backward()
        return x.grad

    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    g = hbptt()
    torch.cuda.synchronize()
    out["launches_bptt"] = P.KERNEL_SINGLE.launches
    peak = torch.cuda.max_memory_allocated() / 1e9
    x_r = taus_g.clone().requires_grad_(True)
    (g_reg,) = torch.autograd.grad(1e-4 * (x_r**2).mean(), x_r)
    d_dyn = g - g_reg
    share_g = (d_dyn != 0).any(-1).any(0).double().mean().item()
    finite_g = bool(torch.isfinite(g).all())
    print(f"[humanoid-main] BPTT (rollout_checkpointed, contact_budget=12, D = {D_bud}) B={Bg} T={Tg} f32, "
          f"tau = 0.5 N(0,1), loss mean(q_T[:, 2]^2) + 1e-4 mean(tau^2): {out['launches_bptt']} sweep "
          f"launches; dtau finite {finite_g}, through the dynamics non-zero on {100 * share_g:.2f}% of "
          f"envs, max {d_dyn.abs().max().item():.3e}; peak memory {peak:.3f} GB")
    check(out["launches_bptt"] == Tg, f"expected {Tg} sweep launches in the humanoid BPTT")
    check(finite_g and share_g >= 0.99, "bad humanoid BPTT gradient")
    bptt = median_ms(hbptt, warm=False)  # hbptt has just run
    with torch.no_grad():
        step_ms = cuda_ms(lambda: S.step(mp, st_f, taus_f[0]), reps=5)
        busy, kern, _, _ = device_profile(lambda: S.step(mp, st_f, taus_f[0]), steps=1)
        step_g_ms = cuda_ms(lambda: S.step(mg, st_g, taus_g[0]), reps=5)
        busy_g, kern_g, _, _ = device_profile(lambda: S.step(mg, st_g, taus_g[0]), steps=1)
    out.update(fwd_env_steps_per_s=Bf * Tf / (roll[0] * 1e-3),
               fwd_grad_env_steps_per_s=Bg * Tg / (bptt[0] * 1e-3))
    print(f"[humanoid-main] timing on {card}: rollout median {roll[0]:.2f} ms (min {roll[1]:.2f}, max "
          f"{roll[2]:.2f}, 5 runs) = {out['fwd_env_steps_per_s']:.6g} fwd env-steps/s; BPTT median "
          f"{bptt[0]:.1f} ms (min {bptt[1]:.1f}, max {bptt[2]:.1f}, 5 runs) = "
          f"{out['fwd_grad_env_steps_per_s']:.6g} fwd+grad env-steps/s; one vmap step (torch.profiler): "
          f"B={Bf} D={D_full} {step_ms:.3f} ms, {kern:.0f} kernels, device busy {busy:.3f} ms, idle "
          f"{100 * (1 - busy / step_ms):.1f}%; B={Bg} D={D_bud} {step_g_ms:.3f} ms, {kern_g:.0f} kernels, "
          f"busy {busy_g:.3f} ms, idle {100 * (1 - busy_g / step_g_ms):.1f}%")

    # ---- 24. humanoid-reference: f64 gradients, Jacobians, the catapult ----
    m64r = mh[f64].replace(contact_budget=12, contact_solver="lowrank")
    Br, Tr = 64, 5
    st_r = State(q=humanoid_init_q(m64r).repeat(Br, 1), v=torch.zeros(Br, m64r.nv, dtype=f64, device="cuda"))
    taus_r = torch.tensor(0.5 * np.random.RandomState(10).randn(Tr, Br, m64r.nv), dtype=f64, device="cuda")
    conv = torch.ones(Br, dtype=torch.bool, device="cuda")
    with torch.no_grad():
        s_ = st_r
        for t in range(Tr):
            conv &= solver_diagnostics(m64r, s_, taus_r[t]) < 1e-8
            s_ = S.step(m64r, s_, taus_r[t])
    w = conv.double()

    def grads(model):
        x = taus_r.clone().requires_grad_(True)
        fin = S.rollout_checkpointed(model, st_r, x)
        return torch.autograd.grad((w * fin.q[:, 2] ** 2).sum() / w.sum(), x)[0]

    reset_counts()
    gk = grads(m64r.replace(contact_solver="lowrank_pallas"))
    torch.cuda.synchronize()
    launches_r = P.KERNEL_SINGLE.launches
    gp = grads(m64r)
    tol = vc.VJP_RTOL * gp.abs() + vc.VJP_ATOL * gp.abs().max()
    ok_r = bool(((gk - gp).abs() <= tol)[:, conv].all())
    print(f"[humanoid-reference] f64 B={Br} T={Tr} contact_budget=12, tau = 0.5 N(0,1), {int(conv.sum())} "
          f"converged envs: d mean(q_T[:, 2]^2) / dtau through the kernel ({launches_r} launches) vs the "
          f"plain sweeps, max |difference| {(gk - gp)[:, conv].abs().max().item():.3e} of max |dtau| "
          f"{gp.abs().max().item():.3e} (limits rtol {vc.VJP_RTOL:g} + atol {vc.VJP_ATOL:g})")
    check(launches_r == Tr, f"expected {Tr} sweep launches in the f64 humanoid gradient")
    check(int(conv.sum()) >= Br // 2, "too few converged envs for the humanoid reference check")
    check(bool(gp.abs().max() > 0), "zero reference gradient")
    check(ok_r, "the humanoid's f64 gradient through the sweep kernel disagrees with the plain sweeps")

    tau0 = torch.zeros(Bf, mp.nv, device="cuda")
    reset_counts()
    jac = timestep_jacobians(mp, st_f, tau0)
    torch.cuda.synchronize()
    out["launches_jacobians"] = P.KERNEL_SINGLE.launches
    fin_j = torch.stack([torch.isfinite(x).flatten(1).all(1) for x in jac]).all(0).double().mean().item()
    jt = median_ms(lambda: timestep_jacobians(mp, st_f, tau0), runs=5, warm=False)
    out["jacobian_sets_per_s"] = Bf / (jt[0] * 1e-3)
    print(f"[humanoid-reference] timestep_jacobians B={Bf} f32 lowrank_pallas, standing, every slot: "
          f"7 blocks, finite on {100 * fin_j:.2f}% of envs; {out['launches_jacobians']} sweep launch(es) "
          f"per call; timing on {card}: median {jt[0]:.1f} ms (min {jt[1]:.1f}, max {jt[2]:.1f}, 5 runs) "
          f"= {out['jacobian_sets_per_s']:.6g} env-Jacobian-sets/s")
    check(len(jac) == 7 and tuple(jac.vel_vel.shape) == (Bf, 30, 30), "bad humanoid Jacobian shapes")
    check(fin_j >= 0.99, "non-finite humanoid Jacobians on > 1% of envs")
    check(out["launches_jacobians"] == 1, "expected 1 sweep launch per humanoid Jacobian call")

    cp = cat.replace(contact_solver="lowrank_pallas")
    Bc = 256
    st_c = State(q=catapult_init_q(cp).repeat(Bc, 1), v=torch.zeros(Bc, cp.nv, device="cuda"))
    with torch.no_grad():
        reset_counts()
        fin_c = S.rollout_final(cp, st_c, torch.zeros(100, Bc, cp.nv, device="cuda"))
        torch.cuda.synchronize()
        out["launches_catapult"] = P.KERNEL_SINGLE.launches
    finite_c = bool(torch.isfinite(fin_c.q).all() and torch.isfinite(fin_c.v).all())
    print(f"[humanoid-reference] catapult B={Bc} f32 lowrank_pallas, 100 steps: {out['launches_catapult']} "
          f"sweep launches; finite {finite_c}; ball at {[round(x, 4) for x in fin_c.q[0, 6:9].tolist()]}")
    check(out["launches_catapult"] == 100, "expected 100 sweep launches in the catapult run")
    check(finite_c, "non-finite catapult state")
    return out


def octa_model(dtype, device):
    """tests/test_tilestep_hybrid.py's octahedron: a free body whose convex
    hull has 6 vertices, on a plane, pivot refinement off."""
    from diffdart_tpu_torch.dynamics.model import GeomType, JointType, ModelBuilder

    b = ModelBuilder(dt=2e-3)
    body = b.add_body(parent=-1, jtype=JointType.FREE, mass=1.0, inertia=np.eye(3) * 0.004)
    verts = 0.1 * np.array([[1, 0, 0], [-1, 0, 0], [0, 1, 0], [0, -1, 0], [0, 0, 1], [0, 0, -1.0]])
    b.add_geom(body, GeomType.CONVEX, verts=verts, friction=0.6)
    b.add_geom(-1, GeomType.PLANE, friction=0.6)
    return b.finalize(dtype=dtype, device=device).replace(lcp_pivot_iters=0)


def over_cap_models():
    """Two float32 models on the card, each over one of kernel 1's caps, with
    the reason kernel_unsupported_reason gives: the 17-body chain of
    tests/test_torch_cuda.py and the three 32-vertex hulls of
    tests/test_torch_fused_convex.py."""
    from diffdart_tpu_torch.dynamics.model import GeomType, JointType, ModelBuilder
    from diffdart_tpu_torch.ops import fused_step as fs

    b = ModelBuilder(dt=1e-3)
    prev = -1
    for _ in range(fs.MAX_NB + 1):
        prev = b.add_body(parent=prev, jtype=JointType.REVOLUTE, axis=(0, 1, 0), X_pos=(0, 0, -0.1))
    chain = b.finalize(dtype=torch.float32, device="cuda")
    rng = np.random.RandomState(8)
    b = ModelBuilder(dt=2e-3)
    body = b.add_body(parent=-1, jtype=JointType.FREE, mass=1.0, inertia=np.eye(3) * 0.004)
    for k in range(3):
        pts = rng.randn(200, 3)
        b.add_geom(body, GeomType.CONVEX, verts=0.1 * pts / np.linalg.norm(pts, axis=1, keepdims=True),
                   pos=(0.1 * k, 0, 0))
    b.add_geom(-1, GeomType.PLANE)
    hulls = b.finalize(dtype=torch.float32, device="cuda")
    return [(chain, f"bodies = {fs.MAX_NB + 1} exceeds the kernel's cap of {fs.MAX_NB}"),
            (hulls, f"hull vertices = 96 exceeds the kernel's cap of {fs.MAX_HULL_VERTS}")]


def octa_state(B_, seed, dtype, device):
    """Random attitudes, the centre 0.1 +- 0.04 above the plane, v ~ 0.5 N(0,1)."""
    from diffdart_tpu_torch.dynamics.model import State

    rng = np.random.RandomState(seed)
    quat = rng.randn(B_, 4)
    quat /= np.linalg.norm(quat, axis=1, keepdims=True)
    pos = np.stack([0.05 * rng.randn(B_), 0.05 * rng.randn(B_), 0.1 + 0.04 * rng.randn(B_)], 1)
    return State(q=torch.tensor(np.concatenate([quat, pos], 1), dtype=dtype, device=device),
                 v=torch.tensor(0.5 * rng.randn(B_, 6), dtype=dtype, device=device))


def sphere_field(n, budget, dtype, device):
    """tests/test_broadphase.py's field: n free spheres (r = 0.1) over a
    plane, n sphere-plane and n (n - 1) / 2 sphere-sphere pairs."""
    from diffdart_tpu_torch.dynamics.model import GeomType, JointType, ModelBuilder

    b = ModelBuilder(dt=2e-3)
    for i in range(n):
        bi = b.add_body(parent=-1, jtype=JointType.FREE, mass=0.5, inertia=np.eye(3) * 0.002)
        b.add_geom(bi, GeomType.SPHERE, size=(0.1, 0, 0), friction=0.5)
    b.add_geom(-1, GeomType.PLANE, friction=0.5)
    m = b.finalize(dtype=dtype, device=device)
    return m.replace(pair_budget=budget) if budget else m


def field_q(n, B_, seed):
    """A sparse field: spheres 0.5 m apart on a 4-wide grid, the first n/2
    resting 0.5 mm into the plane, the rest 0.4 m up, spheres 0 and 1
    5 mm into each other; each env's grid moved by 2 mm N(0,1) in x and y.
    At most n/2 plane pairs and one sphere pair touch, so a pair budget of
    n/2 culls only pairs that make no contact."""
    rng = np.random.RandomState(seed)
    q = np.array([[1.0, 0, 0, 0, (i % 4) * 0.5, (i // 4) * 0.5, 0.0995 if i < n // 2 else 0.5]
                  for i in range(n)])
    q[1, 4] = 0.195
    q = np.tile(q[None], (B_, 1, 1))
    q[:, :, 4:6] += 0.002 * rng.randn(B_, 1, 2)
    return q.reshape(B_, 7 * n)


def slice9_phases(card, reset_counts):
    """Phases 25-28: convex and hybrid models, the pair-budget broadphase,
    the dynamics API and trajectory optimization on the card. Returns the
    sweep kernels' launch counts on these paths for the kernel line."""
    import warnings

    from diffdart_tpu_torch import dynamics as dyn
    from diffdart_tpu_torch.dynamics.model import State
    from diffdart_tpu_torch.models import humanoid, jump_worm
    from diffdart_tpu_torch.ops import fused_step as fs
    from diffdart_tpu_torch.ops import pallas_lcp as P
    from diffdart_tpu_torch.ops import sweep_check as sc
    from diffdart_tpu_torch.ops.lcp import _jacobi
    from diffdart_tpu_torch.sim import step as S
    from diffdart_tpu_torch.sim.batched import step_batched
    from diffdart_tpu_torch.sim.constrained import prepare_constrained
    from diffdart_tpu_torch.sim.fast import rollout_fast
    from diffdart_tpu_torch.sim.tilestep import build_tile_step
    device_profile = _script("torch_vmap_timing").device_profile

    f32, f64 = torch.float32, torch.float64
    out = {"shapes": []}

    def sweeps_vs_plain(case, model, state, tau=None):
        """The sweep kernel against _jacobi on the LCPs that
        prepare_constrained assembles at `state`, in the solve's dtype
        (float64 under lcp_dtype='f64'), as phase 22 does for the humanoid.
        These launches are made outside the counted runs."""
        with torch.no_grad():
            lcp = prepare_constrained(model, state, tau)[0]
            args = [lcp.A, lcp.b, lcp.lo, lcp.hi, lcp.mu]
            if model.lcp_dtype == "f64":
                args = [x.to(f64) for x in args]
            it = model.contact_iters
            got = P.jacobi_sweeps_pallas_single(*args, lcp.fidx, it)
            want = _jacobi(*args, lcp.fidx, it)
        torch.cuda.synchronize()
        err, rel = sc.sweep_error(got, want)
        B_, D_ = lcp.b.shape
        name = str(args[1].dtype)[6:]
        active = (want.abs() > 0).double().mean().item()
        print(f"[sweeps] {case}: B={B_} D={D_} {name} iters={it}: kernel vs _jacobi max |dlam| "
              f"{err:.3e}, max relative {rel:.3e} (limit {sc.REL_F64 if name == 'float64' else sc.REL_F32:g}); "
              f"{100 * active:.1f}% of impulses nonzero")
        check(sc.sweep_ok(got, want), f"{case}: the sweep kernel disagrees with _jacobi (D={D_}, {name})")
        out["shapes"].append({"case": case, "B": B_, "D": D_, "dtype": name, "max_abs_err": err,
                              "max_rel_err": rel})

    def warned_fallback(model, state, taus):
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            with torch.no_grad():
                fin = rollout_fast(model, state, taus)
        return fin, [str(w.message) for w in caught if issubclass(w.category, UserWarning)]

    # ---- 25. convex-hybrid: convex slots and the hybrid LCP ----
    # the octahedron on the vmap stack: rollout_fast takes kernel 1 for it
    # now (phase 29), so the vmap stack's rollout is called directly
    mo = octa_model(f32, "cuda").replace(contact_solver="lowrank_pallas")
    Bo, To = 4096, 10
    st_o = octa_state(Bo, 1, f32, "cuda")
    taus_o = torch.tensor(0.1 * np.random.RandomState(2).randn(To, Bo, 6), dtype=f32, device="cuda")

    def vmap_octa():
        with torch.no_grad():
            return S.rollout(mo, st_o, taus_o)[0]

    reset_counts()
    fin_o = vmap_octa()
    torch.cuda.synchronize()
    out["launches_convex_rollout"] = P.KERNEL_SINGLE.launches
    fused_o = fs.KERNEL.launches
    finite_o = bool(torch.isfinite(fin_o.q).all() and torch.isfinite(fin_o.v).all())
    roll_o = median_ms(vmap_octa, runs=3)
    out["convex_vmap_ms"] = roll_o[0]
    print(f"[convex-hybrid] octahedron hull on a plane, the vmap stack (sim/step.py::rollout) "
          f"B={Bo} T={To} f32 lowrank_pallas: {out['launches_convex_rollout']} jacobi_sweeps_single "
          f"launches, {fused_o} fused-step launches; finite {finite_o}; timing on {card}: median "
          f"{roll_o[0]:.2f} ms (min {roll_o[1]:.2f}, max {roll_o[2]:.2f}, 3 runs) = "
          f"{Bo * To / (roll_o[0] * 1e-3):.6g} fwd env-steps/s")
    check(out["launches_convex_rollout"] == To and fused_o == 0, "the convex model missed the vmap stack")
    check(finite_o, "non-finite convex rollout")
    reset_counts()
    with torch.no_grad():
        step_batched(mo, st_o, taus_o[0])
    torch.cuda.synchronize()
    out["launches_convex_step_batched"] = P.KERNEL.launches
    check(out["launches_convex_step_batched"] == 1, "expected one batched sweep launch")
    sweeps_vs_plain("octahedron", mo, st_o, taus_o[0])

    # float64: the card's vmap step against the CPU's plain fused step (the
    # tile twin with its convex slots), 16 envs, 10 re-synced steps
    m64c = octa_model(f64, "cuda").replace(contact_solver="lowrank_pallas")
    twin = build_tile_step(octa_model(f64, "cpu"), output="stacked")
    st = octa_state(16, 3, f64, "cuda")
    tau16 = torch.tensor(0.1 * np.random.RandomState(4).randn(16, 6), dtype=f64, device="cuda")
    worst_q = worst_v = 0.0
    share = 1.0
    with torch.no_grad():
        for _ in range(10):
            sc_ = S.step(m64c, st, tau16)
            qt, vt = twin(st.q.cpu().T.contiguous(), st.v.cpu().T.contiguous(), tau16.cpu().T.contiguous())
            dq = (sc_.q.cpu() - qt.T).abs().amax(1)
            dv = (sc_.v.cpu() - vt.T).abs().amax(1)
            share = min(share, ((dq <= 1e-7) & (dv <= 1e-5)).double().mean().item())
            worst_q, worst_v = max(worst_q, dq.max().item()), max(worst_v, dv.max().item())
            st = State(q=sc_.q, v=sc_.v)
    print(f"[convex-hybrid] f64, 16 envs, 10 re-synced steps: the card's vmap step vs the CPU's plain "
          f"fused step (convex slots): max |dq| {worst_q:.3e}, |dv| {worst_v:.3e}; >= "
          f"{100 * share:.1f}% of envs within q 1e-7, v 1e-5 at every step")
    check(share >= 0.99, "the convex model's card step disagrees with the CPU's tile twin")

    # the 2-link worm with contact_budget=3, for which lcp 'auto' picks the
    # hybrid LCP: rollout_tiled's hybrid branch on the card against the CPU
    Bw, Tw = 256, 5
    rng = np.random.RandomState(6)
    mc = jump_worm(dt=2e-3, n_links=2, dtype=f64, device="cuda").replace(contact_budget=3)
    mcpu = jump_worm(dt=2e-3, n_links=2, dtype=f64, device="cpu").replace(contact_budget=3)
    check(fs.lcp_mode(mc) == "xla", "the budgeted worm is not in the hybrid LCP mode")
    q0 = mc.neutral_q().cpu().numpy() + np.array([0.06, 0.0, 0.25, -0.5])
    q = np.tile(q0, (Bw, 1)) + 0.05 * rng.randn(Bw, mc.nq)
    v = 0.3 * rng.randn(Bw, mc.nv)
    taus = 0.15 * rng.randn(Tw, Bw, mc.nv)
    st_c = State(q=torch.tensor(q, device="cuda"), v=torch.tensor(v, device="cuda"))
    taus_c = torch.tensor(taus, device="cuda")
    reset_counts()
    t0 = time.perf_counter()
    with torch.no_grad():
        fin_c = fs.rollout_tiled(mc, st_c, taus_c)
        torch.cuda.synchronize()
        first_ms = 1e3 * (time.perf_counter() - t0)
        hyb = median_ms(lambda: fs.rollout_tiled(mc, st_c, taus_c), runs=3, warm=False)
    fused_w = fs.KERNEL.launches
    with torch.no_grad():
        fin_h = fs.rollout_tiled(mcpu, State(q=torch.tensor(q), v=torch.tensor(v)), torch.tensor(taus))
    dq = (fin_c.q.cpu() - fin_h.q).abs().amax(1)
    dv = (fin_c.v.cpu() - fin_h.v).abs().amax(1)
    ok_share = ((dq <= 1e-7) & (dv <= 1e-5)).double().mean().item()
    check(ok_share >= 0.99, "rollout_tiled's hybrid branch disagrees between the card and the CPU")
    check(fused_w == 0, "rollout_tiled launched the fused-step kernel for a hybrid model")
    mb = jump_worm(dt=2e-3, n_links=2, dtype=f32, device="cuda").replace(
        contact_budget=3, contact_solver="lowrank_pallas")
    st_w = State(q=torch.tensor(np.tile(q0, (Bw, 1)), dtype=f32, device="cuda"),
                 v=torch.zeros(Bw, mb.nv, dtype=f32, device="cuda"))
    reset_counts()
    fin_w, msgs_w = warned_fallback(mb, st_w, torch.zeros(Tw, Bw, mb.nv, device="cuda"))
    torch.cuda.synchronize()
    out["launches_hybrid_fallback"] = P.KERNEL_SINGLE.launches
    print(f"[convex-hybrid] 2-link worm, budget 3, rollout_tiled's hybrid branch on the card, B={Bw} "
          f"T={Tw} f64, vs the CPU: max |dq| {dq.max().item():.3e}, |dv| {dv.max().item():.3e}, "
          f"{100 * ok_share:.1f}% of envs within q 1e-7, v 1e-5, {fused_w} fused-step launches; "
          f"first call {first_ms:.0f} ms, then median {hyb[0]:.1f} ms (min {hyb[1]:.1f}, max "
          f"{hyb[2]:.1f}, 3 runs); rollout_fast, f32: warning {msgs_w[:1]}, {out['launches_hybrid_fallback']} "
          f"sweep launches")
    check(len(msgs_w) == 1 and "hybrid LCP runs outside the kernel" in msgs_w[0],
          "rollout_fast did not name the hybrid reason")
    check(out["launches_hybrid_fallback"] == Tw, "the budgeted worm missed the sweep kernel")
    check(bool(torch.isfinite(fin_w.q).all()), "non-finite budgeted worm")
    sweeps_vs_plain("worm, budget 3", mb, State(q=torch.tensor(q, dtype=f32, device="cuda"),
                                                v=torch.tensor(v, dtype=f32, device="cuda")))

    # ---- 26. pair-budget: the AABB broadphase on the vmap stack ----
    n, Bp, Tp = 16, 1024, 20
    mpb = sphere_field(n, 8, f32, "cuda").replace(contact_solver="lowrank_pallas")
    from diffdart_tpu_torch.collision.collide import max_contacts
    st_p = State(q=torch.tensor(field_q(n, Bp, 7), dtype=f32, device="cuda"),
                 v=torch.zeros(Bp, mpb.nv, dtype=f32, device="cuda"))
    taus_p = torch.zeros(Tp, Bp, mpb.nv, dtype=f32, device="cuda")
    with torch.no_grad():
        reset_counts()
        fin_p, _ = S.rollout(mpb, st_p, taus_p)
        torch.cuda.synchronize()
        out["launches_pair_budget"] = P.KERNEL_SINGLE.launches
        roll_p = median_ms(lambda: S.rollout(mpb, st_p, taus_p), runs=3)
        busy_p, kern_p, _, _ = device_profile(lambda: S.step(mpb, st_p, taus_p[0]), steps=1)
        step_p = cuda_ms(lambda: S.step(mpb, st_p, taus_p[0]), reps=5)
        reset_counts()
        step_batched(mpb, st_p, taus_p[0])
        torch.cuda.synchronize()
        out["launches_pair_budget_step_batched"] = P.KERNEL.launches
    finite_p = bool(torch.isfinite(fin_p.q).all())
    print(f"[pair-budget] sphere field n={n} ({n} sphere-plane, {n * (n - 1) // 2} sphere-sphere pairs), "
          f"pair_budget=8: {max_contacts(mpb)} slots; rollout B={Bp} T={Tp} f32 lowrank_pallas: "
          f"{out['launches_pair_budget']} sweep launches, finite {finite_p}; timing on {card}: median "
          f"{roll_p[0]:.2f} ms (min {roll_p[1]:.2f}, max {roll_p[2]:.2f}, 3 runs) = {roll_p[0] / Tp:.3f} "
          f"ms per step, {Bp * Tp / (roll_p[0] * 1e-3):.6g} env-steps/s; one step (torch.profiler) "
          f"{step_p:.3f} ms, {kern_p:.0f} kernels, device busy {busy_p:.3f} ms, idle "
          f"{100 * (1 - busy_p / step_p):.1f}%; step_batched {out['launches_pair_budget_step_batched']} "
          f"batched launch")
    check(max_contacts(mpb) == 16, "bad pair-budget slot count")
    check(out["launches_pair_budget"] == Tp and out["launches_pair_budget_step_batched"] == 1,
          "the pair-budget field missed the sweep kernel")
    check(finite_p, "non-finite pair-budget rollout")
    sweeps_vs_plain("sphere field, pair budget 8", mpb, st_p, taus_p[0])
    # float64: budgeted against the full plan while the scene is sparse
    # (both with the plain sweeps: the full plan's 408 rows are past the
    # kernel's float64 cap)
    Bs_, Ts_ = 8, 30
    st_s = State(q=torch.tensor(field_q(n, Bs_, 8), dtype=f64, device="cuda"),
                 v=torch.zeros(Bs_, 6 * n, dtype=f64, device="cuda"))
    taus_s = torch.zeros(Ts_, Bs_, 6 * n, dtype=f64, device="cuda")
    with torch.no_grad():
        _, tr_b = S.rollout(sphere_field(n, 8, f64, "cuda"), st_s, taus_s)
        _, tr_f = S.rollout(sphere_field(n, 0, f64, "cuda"), st_s, taus_s)
    d_bf = (tr_b.q - tr_f.q).abs().max().item()
    z_end = tr_f.q[-1].reshape(Bs_, n, 7)[:, :, 6]
    print(f"[pair-budget] f64 B={Bs_} T={Ts_}, budget 8 vs the full plan ({3 * max_contacts(sphere_field(n, 0, f64, 'cuda'))} "
          f"rows): max |dq| over the trajectory {d_bf:.3e} (limit 1e-9); heights at the end "
          f"{z_end.min().item():.4f}-{z_end.max().item():.4f}")
    check(d_bf <= 1e-9, "the budgeted field differs from the full plan while sparse")

    # ---- 27. dynamics-api: forward and inverse dynamics of the humanoid ----
    Bh = 256
    mh64 = humanoid(dtype=f64, device="cuda")
    rng = np.random.RandomState(12)
    from diffdart_tpu_torch.models import humanoid_init_q
    qh = np.tile(humanoid_init_q(mh64).cpu().numpy(), (Bh, 1))
    qh[:, 7:] += 0.05 * rng.randn(Bh, mh64.nq - 7)
    vh_, tauh = 0.3 * rng.randn(Bh, mh64.nv), rng.randn(Bh, mh64.nv)
    args_c = [torch.tensor(x, dtype=f64, device="cuda") for x in (qh, vh_, tauh)]
    qdd = dyn.forward_dynamics(mh64, *args_c)
    tau_back = dyn.inverse_dynamics(mh64, args_c[0], args_c[1], qdd)
    mh_cpu = humanoid(dtype=f64, device="cpu")
    args_h = [torch.tensor(x, dtype=f64) for x in (qh, vh_, tauh)]
    qdd_h = dyn.forward_dynamics(mh_cpu, *args_h)
    tau_h = dyn.inverse_dynamics(mh_cpu, args_h[0], args_h[1], qdd_h)
    e_fd = (qdd.cpu() - qdd_h).abs().max().item() / max(1.0, qdd_h.abs().max().item())
    e_id = (tau_back.cpu() - tau_h).abs().max().item() / max(1.0, tau_h.abs().max().item())
    e_rt = (tau_back - args_c[2]).abs().max().item()
    fd_ms = cuda_ms(lambda: dyn.forward_dynamics(mh64, *args_c), reps=5)
    print(f"[dynamics-api] humanoid B={Bh} f64: forward_dynamics card vs CPU {e_fd:.3e}, "
          f"inverse_dynamics {e_id:.3e} (relative to max(1, max |x|), limit 1e-10); round trip "
          f"max |inverse(forward(tau)) - tau| {e_rt:.3e} (limit 1e-8); forward_dynamics {fd_ms:.2f} ms")
    check(e_fd <= 1e-10 and e_id <= 1e-10, "forward/inverse dynamics differ between the card and the CPU")
    check(e_rt <= 1e-8, "inverse dynamics does not undo forward dynamics")

    # ---- 28. trajectory: the catapult's BPTT, the jump-worm's iLQR, one MPC solve ----
    cat_mod = _script("torch_catapult_shooting")
    mcat = cat_mod.build("cuda")
    roll_c, landing_x, us_hold = cat_mod.problem(mcat)
    us = us_hold.clone()
    us[:40, 0] += -20.0
    us[:40, 1] += -6.0
    us.requires_grad_(True)
    opt = torch.optim.Adam([us], lr=0.5)
    losses, times, launch_it = [], [], []
    for _ in range(5):
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        opt.zero_grad()
        loss = -landing_x(roll_c(us)) + 1e-5 * (us**2).sum()
        loss.backward()
        opt.step()
        losses.append(loss.item())
        times.append(1e3 * (time.perf_counter() - t0))
        launch_it.append(P.KERNEL_SINGLE.launches)
    out["launches_catapult_iter"] = launch_it[-1]
    print(f"[trajectory] catapult BPTT (examples/catapult_shooting.py's config: T=150, f32 + f64 island, "
          f"lowrank_pallas, Adam 0.5; 5 of its 200 iterations): loss {[round(x, 3) for x in losses]}; "
          f"{launch_it[-1]} sweep launches per iteration; median {sorted(times)[2]:.0f} ms per "
          f"iteration on {card}")
    check(losses[-1] < losses[0] and all(np.isfinite(losses)), "the catapult's loss did not fall")
    check(launch_it[-1] == 150, "expected one sweep launch per catapult step")
    # float64 gradient at the warm start: card against CPU
    grads = {}
    for dev in ("cuda", "cpu"):
        m_ = cat_mod.build(dev).astype(f64).replace(lcp_dtype="state")
        r_, lx_, h_ = cat_mod.problem(m_)
        u_ = h_.clone()
        u_[:40, 0] += -20.0
        u_[:40, 1] += -6.0
        u_.requires_grad_(True)
        (g_,) = torch.autograd.grad(-lx_(r_(u_)) + 1e-5 * (u_**2).sum(), u_)
        grads[dev] = g_.cpu()
    e_g = ((grads["cuda"] - grads["cpu"]).abs().max() / grads["cpu"].abs().max()).item()
    print(f"[trajectory] catapult f64 gradient at the warm start, card (lowrank_pallas) vs CPU (lowrank): "
          f"max |difference| {e_g:.3e} of max |g| {grads['cpu'].abs().max().item():.3e} (limit 1e-6)")
    check(e_g <= 1e-6, "the catapult's float64 gradient differs between the card and the CPU")
    # the catapult's LCPs (float64 island): the initial state at the path's
    # B = 1, and the warm start's first 40 states (the swing pulse) as one batch
    from diffdart_tpu_torch.models import catapult_init_q
    u_w = us_hold.clone()
    u_w[:40, 0] += -20.0
    u_w[:40, 1] += -6.0
    tau_w = torch.cat([u_w, torch.zeros(u_w.shape[0], mcat.nv - 2, dtype=f32, device="cuda")], 1)
    s_c = State(q=catapult_init_q(mcat)[None], v=torch.zeros(1, mcat.nv, dtype=f32, device="cuda"))
    sweeps_vs_plain("catapult, initial state", mcat, s_c, tau_w[:1])
    qs_c, vs_c = [], []
    with torch.no_grad():
        for t in range(40):
            qs_c.append(s_c.q)
            vs_c.append(s_c.v)
            s_c = S.step(mcat, s_c, tau_w[t:t + 1])
    sweeps_vs_plain("catapult, the warm start's first 40 states", mcat,
                    State(q=torch.cat(qs_c), v=torch.cat(vs_c)), tau_w[:40])

    worm_mod = _script("torch_jumpworm_ilqr")
    import importlib
    il = importlib.import_module("diffdart_tpu_torch.trajectory.ilqr")
    mw = worm_mod.build("cuda")
    f_w, rc_w, tc_w, x0_w, us0_w = worm_mod.problem(mw)
    lin = [0.0]
    inner = il._linearize

    def timed(*a):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = inner(*a)
        torch.cuda.synchronize()
        lin[0] += time.perf_counter() - t0
        return r

    il._linearize = timed
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    try:
        res_w = il.ilqr(f_w, rc_w, tc_w, x0_w, us0_w, iters=2)
        torch.cuda.synchronize()
    finally:
        il._linearize = inner
    wall_w = time.perf_counter() - t0
    out["launches_jumpworm_ilqr"] = P.KERNEL_SINGLE.launches
    print(f"[trajectory] jump-worm iLQR (examples/jumpworm_ilqr.py's config: 3 links, dt 5e-3, T=60, f32 "
          f"+ f64 island, lowrank_pallas; 2 of its 20 iterations): cost {res_w.cost_trace.tolist()}; "
          f"{1e3 * wall_w / 2:.0f} ms per iteration on {card}, {100 * lin[0] / wall_w:.1f}% in the "
          f"batched linearization (one step of B = 60 envs, 10 backward passes); "
          f"{out['launches_jumpworm_ilqr']} sweep launches")
    check(bool(torch.isfinite(res_w.xs).all()), "non-finite jump-worm iLQR")
    check(out["launches_jumpworm_ilqr"] > 0, "the jump-worm's iLQR missed the sweep kernel")
    # its LCPs (float64 island) at the B = 60 states of the linearization
    xs_w, nq_w = res_w.xs[:-1], mw.nq
    u_lin = worm_mod.U_MAX * torch.tanh(res_w.us / worm_mod.U_MAX)
    sweeps_vs_plain("jump-worm, the iLQR trajectory", mw, State(q=xs_w[:, :nq_w], v=xs_w[:, nq_w:]),
                    torch.cat([torch.zeros(u_lin.shape[0], 3, dtype=f32, device="cuda"), u_lin], 1))

    from diffdart_tpu_torch.models import cartpole
    from diffdart_tpu_torch.trajectory.ilqr import make_dynamics
    from diffdart_tpu_torch.trajectory.mpc import MPC
    mcp = cartpole(dt=0.02, dtype=f32, device="cuda")
    f_c = make_dynamics(mcp, control_map=lambda u: torch.cat([u, torch.zeros_like(u)], dim=-1))
    mpc = MPC(f_c, lambda x, u, t: 1e-3 * u[0] ** 2 + x[1] ** 2 + 0.1 * x[0] ** 2 + 0.01 * (x[2] ** 2 + x[3] ** 2),
              lambda x: 100.0 * torch.sum(x**2), horizon=40, nu=1, dt=0.02, iters_per_solve=6)
    x_c = torch.tensor([0.0, 0.6, 0.0, 0.0], device="cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res_m = mpc.solve(x_c, 0.0)
    torch.cuda.synchronize()
    mpc_ms = 1e3 * (time.perf_counter() - t0)
    print(f"[trajectory] MPC solve (examples/mpc_cartpole.py's config: horizon 40, 6 iLQR iterations, "
          f"f32): cost {res_m.cost_trace[0].item():.4f} -> {res_m.cost.item():.4f}, {mpc_ms:.0f} ms on {card}")
    check(bool(res_m.cost <= res_m.cost_trace[0]) and bool(torch.isfinite(res_m.us).all()),
          "bad MPC solve")
    return out


def convex_fused_phase(card, lib, reset_counts, vmap_ms):
    """Phase 29: the octahedron (a convex hull of 6 vertices, 4 slots,
    D = 12) on kernels 1 and 2. Returns its numbers for the kernel line."""
    import warnings

    from diffdart_tpu_torch.dynamics.model import State
    from diffdart_tpu_torch.ops import fused_step as fs
    from diffdart_tpu_torch.ops import pallas_lcp as P
    from diffdart_tpu_torch.ops import vjp_check as vc
    from diffdart_tpu_torch.sim.fast import rollout_fast

    f32, f64 = torch.float32, torch.float64
    Bo, To = 4096, 10
    m64, m32 = octa_model(f64, "cuda"), octa_model(f32, "cuda")
    check(fs.kernel_unsupported_reason(m32) is None, "the kernel refuses the octahedron")
    step64, step32 = fs.build_fused_step(m64), fs.build_fused_step(m32)
    D = step32.D
    st = octa_state(Bo, 11, f64, "cpu")
    rng = np.random.RandomState(12)
    q_np, v_np, tau_np = st.q.numpy(), st.v.numpy(), 0.1 * rng.randn(Bo, 6)

    def soa(x, dtype):
        return torch.tensor(np.ascontiguousarray(x.T), dtype=dtype, device="cuda")

    # float64: 20 steps of kernel 1 against the plain version, re-synced
    q, v, tau = (soa(x, f64) for x in (q_np, v_np, tau_np))
    eq = ev = 0.0
    touching = 0
    with torch.no_grad():
        for _ in range(20):
            qk, vk = step64(q, v, tau)
            qp, vp = step64.plain(q, v, tau)
            eq = max(eq, (qk - qp).abs().max().item())
            ev = max(ev, (vk - vp).abs().max().item())
            touching += int((q[6] < 0.1).sum())
            q, v = qp, vp
    print(f"[convex-fused] octahedron (D = {D}, 4 slots), f64, 20 re-synced steps at B={Bo}: max |dq| "
          f"{eq:.3e} (tol 1e-8), max |dv| {ev:.3e} (tol 1e-7); {touching} env-steps with the centre "
          f"below 0.1 m (a vertex under the plane)")
    check(eq <= 1e-8 and ev <= 1e-7, "float64 convex kernel disagrees with the plain version")
    check(touching > 0, "no convex contact in the float64 check")
    # float32: one step
    q, v, tau = (soa(x, f32) for x in (q_np, v_np, tau_np))
    with torch.no_grad():
        qk, vk = step32(q, v, tau)
        qp, vp = step32.plain(q, v, tau)
    torch.cuda.synchronize()
    dq, dv = (qk - qp).abs().amax(0), (vk - vp).abs().amax(0)
    within = ((dq <= 1e-4) & (dv <= 5e-2)).float().mean().item()
    f32_err = max(dq.max().item(), dv.max().item())
    print(f"[convex-fused] f32, one step at B={Bo}: |dq| max {dq.max().item():.3e}, |dv| max "
          f"{dv.max().item():.3e}; {100 * within:.2f}% of envs within q 1e-4, v 5e-2")
    check(bool(torch.isfinite(qk).all() and torch.isfinite(vk).all()), "non-finite float32 convex step")
    check(within >= 0.99, "float32 convex kernel disagrees with the plain version on > 1% of envs")

    # the main path: rollout_fast, T launches of kernel 1 and no warning
    st32 = State(q=torch.tensor(q_np, dtype=f32, device="cuda"), v=torch.tensor(v_np, dtype=f32, device="cuda"))
    taus = torch.tensor(0.1 * rng.randn(To, Bo, 6), dtype=f32, device="cuda")

    def roll():
        with torch.no_grad():
            return rollout_fast(m32, st32, taus)

    reset_counts()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        fin = roll()
        torch.cuda.synchronize()
    launches = fs.KERNEL.launches
    msgs = [str(w.message) for w in caught if issubclass(w.category, UserWarning)]
    sweeps = P.KERNEL_SINGLE.launches
    finite = bool(torch.isfinite(fin.q).all() and torch.isfinite(fin.v).all())
    roll_ms = median_ms(roll, runs=5)
    print(f"[convex-fused] rollout_fast B={Bo} T={To} f32: {launches} fused-step launches, {sweeps} "
          f"sweep launches, warnings {msgs}; finite {finite}; timing on {card}: median "
          f"{roll_ms[0]:.3f} ms (min {roll_ms[1]:.3f}, max {roll_ms[2]:.3f}, 5 runs) = "
          f"{Bo * To / (roll_ms[0] * 1e-3):.6g} fwd env-steps/s; the vmap stack's rollout of the same "
          f"model and size (phase 25) {vmap_ms:.2f} ms, {vmap_ms / roll_ms[0]:.1f}x it")
    check(launches == To and sweeps == 0, f"expected {To} fused-step launches for the octahedron")
    check(not msgs, "rollout_fast warned for the octahedron")
    check(finite, "non-finite convex rollout")

    # rollout_tiled (which rollout_fast ran above) on the card: a model over
    # a cap (the 17-body chain; three 32-vertex hulls, 96 in the pool) is
    # refused with the reason that names the cap, and launches nothing
    for over, want in over_cap_models():
        reset_counts()
        st_o = State(q=over.neutral_q().repeat(64, 1), v=torch.zeros(64, over.nv, device="cuda"))
        try:
            fs.rollout_tiled(over, st_o, torch.zeros(2, 64, over.nv, device="cuda"))
            refused = ""
        except NotImplementedError as e:
            refused = str(e)
        torch.cuda.synchronize()
        print(f"[convex-fused] rollout_tiled on the card refuses a model over a cap: {refused!r}; "
              f"{fs.KERNEL.launches} fused-step launches")
        check(want in refused, f"rollout_tiled did not refuse the model with {want!r}")
        check(fs.KERNEL.launches == 0, "rollout_tiled launched kernel 1 for a model over a cap")

    # BPTT through it: T VJP launches
    def bptt():
        tg = taus.clone().requires_grad_(True)
        f = rollout_fast(m32, st32, tg)
        ((f.q[:, 6] ** 2).mean() + 1e-4 * (tg**2).mean()).backward()
        return tg.grad

    reset_counts()
    dtaus = bptt()
    torch.cuda.synchronize()
    launches_fwd, launches_vjp = fs.KERNEL.launches, fs.VJP_KERNEL.launches
    nonzero = ((dtaus - 2e-4 * taus / taus.numel()).abs() > 0).any(-1).any(0).double().mean().item()
    bptt_ms = median_ms(bptt, runs=5)
    print(f"[convex-fused] BPTT (loss mean(z_T^2) + 1e-4 mean(tau^2)) B={Bo} T={To} f32: "
          f"{launches_fwd} step and {launches_vjp} VJP launches; dtau finite "
          f"{bool(torch.isfinite(dtaus).all())}, non-zero through the kernels on {100 * nonzero:.2f}% "
          f"of envs; median {bptt_ms[0]:.3f} ms (min {bptt_ms[1]:.3f}, max {bptt_ms[2]:.3f}, 5 runs) = "
          f"{Bo * To / (bptt_ms[0] * 1e-3):.6g} fwd+grad env-steps/s")
    check(launches_fwd == To and launches_vjp == To,
          f"expected {To} step and {To} VJP launches, got {launches_fwd}, {launches_vjp}")
    check(bool(torch.isfinite(dtaus).all()), "non-finite convex BPTT gradient")

    # the VJP in float64 against autograd through the plain version
    gq_np, gv_np = rng.randn(Bo, 7), rng.randn(Bo, 6)
    q, v, tau, gq, gv = (soa(x, f64) for x in (q_np, v_np, tau_np, gq_np, gv_np))
    d64 = fs.VJP_KERNEL(*step64.descriptor(q.device, f64), q, v, tau, gq, gv,
                        step64.tape_capacity(q, v, tau), primal=True)
    with torch.no_grad():
        qk, vk = step64(q, v, tau)
    xs = [x.clone().requires_grad_(True) for x in (q, v, tau)]
    want = torch.autograd.grad(step64.plain(*xs), xs, (gq, gv))
    torch.cuda.synchronize()
    share = vc.envs_within(d64[:3], want)
    primal_eq = bool(torch.equal(d64[3], qk) and torch.equal(d64[4], vk))
    vjp_err = max((a - b).abs().max().item() for a, b in zip(d64[:3], want))
    print(f"[convex-fused] VJP f64, one step at B={Bo}: {100 * share:.2f}% of envs within rtol 1e-6 + "
          f"atol 1e-8 max|g|, max |d| {vjp_err:.3e}; the tape's primal == kernel 1's output on all "
          f"{Bo} envs: {primal_eq}")
    check(share >= vc.VJP_SHARE, "float64 convex VJP disagrees with plain autograd on > 1% of envs")
    check(primal_eq, "the convex VJP's primal differs from kernel 1's output")

    # device times beside the bounds, float32
    q, v, tau = (soa(x, f32) for x in (q_np, v_np, tau_np))
    desc = step32.descriptor(q.device, f32)
    nodes = fs.VJP_KERNEL.tape_nodes(*desc, q, v, tau)
    cap = step32.tape_capacity(q, v, tau)
    kernel_ms, issue_ms, (_, _, sol) = step_device_ms(lib, desc, D, q, v, tau, solution=True)
    ones_q, ones_v = torch.ones_like(q), torch.ones_like(v)
    vjp_ms, vjp_issue_ms = vjp_device_ms(lib, desc, q, v, tau, ones_q, ones_v, cap, solution=sol)
    vjp_solving_ms = vjp_device_ms(lib, desc, q, v, tau, ones_q, ones_v, cap)[0]
    with torch.no_grad():
        plain_ms = cuda_ms(lambda: step32.plain(q, v, tau), reps=3)

    def plain_vjp():
        xs = [x.clone().requires_grad_(True) for x in (q, v, tau)]
        torch.autograd.grad(step32.plain(*xs), xs, (ones_q, ones_v))

    plain_vjp_ms = cuda_ms(plain_vjp, reps=1)
    m_cpu = octa_model(f32, "cpu")
    one = [x[:, :1].cpu() for x in (q, v, tau)]
    ops, ops_v = ops_per_env_step(m_cpu, *one), ops_per_env_vjp(m_cpu, *one)
    di, df = fs.pack_descriptor(m32)
    nbytes = (2 * m32.nq + 3 * m32.nv) * 4 * Bo + di.nbytes + df.size * 4
    nbytes_v = (3 * m32.nq + 5 * m32.nv) * 4 * Bo + di.nbytes + df.size * 4
    tb, to = nbytes / HBM_BYTES_PER_S, ops * Bo / F32_OPS_PER_S
    tvb, tvo = nbytes_v / HBM_BYTES_PER_S, ops_v * Bo / F32_OPS_PER_S
    bound_ms, bound_vjp_ms = 1e3 * max(tb, to), 1e3 * max(tvb, tvo)
    print(f"[convex-fused] timing on {card}, B={Bo} f32: step kernel {kernel_ms:.4f} ms/launch on the "
          f"device (issuing {issue_ms:.4f} ms), bound {bound_ms:.3e} ms ({ops} ops/env-step, {nbytes} "
          f"bytes), plain version {plain_ms:.2f} ms; VJP kernel at the saved LCP solution {vjp_ms:.4f} "
          f"ms/launch (issuing {vjp_issue_ms:.4f} ms; solving the LCP itself {vjp_solving_ms:.4f} ms), "
          f"bound {bound_vjp_ms:.3e} ms ({ops_v} ops/env-step, {nbytes_v} "
          f"bytes), plain VJP {plain_vjp_ms:.2f} ms; tape {nodes} nodes per env (capacity {cap}), "
          f"{fs.tape_bytes(f32, nodes, Bo) / 1e6:.3f} MB per launch")
    check(issue_ms < kernel_ms and vjp_issue_ms < vjp_ms, "the convex kernels' timing waited on the host")
    return {"launches": launches, "launches_vjp": launches_vjp, "max_abs_err": f32_err,
            "vjp_max_abs_err_f64": vjp_err, "ms": kernel_ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": "operations" if to >= tb else "bytes",
            "vjp_ms": vjp_ms, "vjp_solving_ms": vjp_solving_ms, "plain_vjp_ms": plain_vjp_ms,
            "bound_vjp_ms": bound_vjp_ms,
            "bound_vjp_by": "operations" if tvo >= tvb else "bytes", "tape_nodes": nodes,
            "rollout_ms": roll_ms[0], "bptt_ms": bptt_ms[0]}


SCENES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "diffdart_tpu_torch", "assets", "scenes")


def loaders_world_phase(card, reset_counts):
    """Phase 30: scene files into Worlds on the card, the stored goldens,
    IK, and the native pivot solver as the oracle of the sweep kernel's
    solves. Returns the sweep launches of its oracle check."""
    from diffdart_tpu_torch.dynamics.kinematics import fk
    from diffdart_tpu_torch.dynamics.model import State
    from diffdart_tpu_torch.math.lie import quat_normalize
    from diffdart_tpu_torch.models import cartpole, chain, cube_drop, double_pendulum
    from diffdart_tpu_torch.neural import HierarchicalIK, solve_ik
    from diffdart_tpu_torch.ops import native_lcp
    from diffdart_tpu_torch.ops import pallas_lcp as P
    from diffdart_tpu_torch.ops.lcp_pivot import solve_residual
    from diffdart_tpu_torch.sim.constrained import prepare_constrained, solve_contact_lcp
    from diffdart_tpu_torch.sim.recording import compare_to_golden
    from diffdart_tpu_torch.sim.step import rollout
    from diffdart_tpu_torch.sim.world import World

    f64 = torch.float64
    out = {}
    # scene files through io.load_into_builder into a World, card vs CPU
    for fname in ("pendulum.skel", "pendulum.sdf", "leg.vsk", "twolink.urdf"):
        ends = []
        for dev in ("cuda", "cpu"):
            w = World(dtype=f64, device=dev)
            w.loadSkeleton(os.path.join(SCENES, fname))
            nv = w.model.nv
            w.setVelocities(0.3 * np.random.RandomState(13).randn(nv))
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(50):
                w.step()
            torch.cuda.synchronize()
            ends.append((w.getPositions().cpu(), w.getVelocities().cpu(), 1e3 * (time.perf_counter() - t0) / 50))
        dq = (ends[0][0] - ends[1][0]).abs().max().item()
        dv = (ends[0][1] - ends[1][1]).abs().max().item()
        print(f"[loaders-world] {fname} -> World on the card, f64, nv={nv}, 50 steps vs the CPU: max |dq| "
              f"{dq:.3e}, |dv| {dv:.3e} (limit 1e-10); {ends[0][2]:.2f} ms per World.step on {card}")
        check(dq <= 1e-10 and dv <= 1e-10, f"{fname}: the World on the card differs from the CPU's")
        check(float((ends[0][0] - w.model.neutral_q().cpu()).abs().max()) > 1e-4, f"{fname}: no motion")

    # the stored goldens, B = 256 copies of each start (tests/test_goldens.py's set-up)
    Bg = 256
    goldens = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests", "goldens")
    for name, (q_tol, v_tol) in (("cartpole", (1e-9, 1e-9)), ("cube_drop", (1e-6, 1e-5)),
                                 ("double_pendulum", (1e-9, 1e-9))):
        runs = {}
        for dev, B_ in (("cuda", Bg), ("cpu", 1)):
            kw = dict(dtype=f64, device=dev)
            if name == "cartpole":
                m = cartpole(dt=5e-3, **kw)
                q0, v0 = torch.tensor([0.1, 0.4], **kw), torch.tensor([-0.2, 0.3], **kw)
                taus = 0.5 * torch.sin(torch.arange(200.0, **kw))[:, None] * torch.tensor([[1.0, 0.0]], **kw)
            elif name == "cube_drop":
                m = cube_drop(dt=2e-3, half=0.1, friction=0.5, restitution=0.3, **kw)
                q0 = m.neutral_q().clone()
                q0[6], q0[1], q0[0] = 0.3, 0.1, 0.99499
                q0[:4] = quat_normalize(q0[:4])
                v0 = torch.zeros(6, **kw)
                v0[3] = 1.0
                taus = torch.zeros(400, 6, **kw)
            else:
                m = double_pendulum(dt=2e-3, **kw)
                q0, v0 = torch.tensor([1.2, -0.5], **kw), torch.zeros(2, **kw)
                taus = torch.zeros(500, 2, **kw)
            s0 = State(q=q0.repeat(B_, 1), v=v0.repeat(B_, 1), t=torch.zeros(B_, **kw))
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with torch.no_grad():
                _, traj = rollout(m, s0, taus[:, None].expand(-1, B_, -1).contiguous())
            torch.cuda.synchronize()
            runs[dev] = (m, traj, 1e3 * (time.perf_counter() - t0) / taus.shape[0])
        m, traj, ms = runs["cuda"]
        path = os.path.join(goldens, f"{name}_f64.npz")
        r = compare_to_golden(traj, path, q_tol=q_tol, v_tol=v_tol)
        rc = compare_to_golden(runs["cpu"][1], path, q_tol=q_tol, v_tol=v_tol)
        print(f"[loaders-world] golden {name}, B={Bg} on {card}, f64: max |dq| {r['max_dq']:.3e} (tol "
              f"{q_tol:g}), |dv| {r['max_dv']:.3e} (tol {v_tol:g}) over every env; the CPU port: "
              f"{rc['max_dq']:.3e}, {rc['max_dv']:.3e}; {ms:.2f} ms per step on the card")
        check(rc["q_ok"] and rc["v_ok"], f"golden {name}: the CPU port breaks it")
        if r["q_ok"] and r["v_ok"]:
            continue
        # the card's summation order leaves the golden: where, by how much,
        # and the card held to the CPU port at that state
        check(name == "cube_drop", f"golden {name}: the card breaks it")
        g = np.load(path)
        qc = traj.q.cpu().numpy()
        over = (np.abs(qc - g["q"][:, None]).max(axis=(1, 2)) > q_tol) | (
            np.abs(traj.v.cpu().numpy() - g["v"][:, None]).max(axis=(1, 2)) > v_tol)
        t_dev = int(np.argmax(over))
        check(t_dev > 0, "cube_drop leaves the golden at its first step")
        cpu_traj = runs["cpu"][1]
        sq = cpu_traj.q[t_dev - 1]
        st_c = State(q=sq.expand(Bg, -1).cuda(), v=cpu_traj.v[t_dev - 1].expand(Bg, -1).cuda())
        with torch.no_grad():
            one_c = rollout(m, st_c, torch.zeros(1, Bg, 6, dtype=f64, device="cuda"))[0]
            one_h = rollout(runs["cpu"][0], State(q=sq, v=cpu_traj.v[t_dev - 1]),
                            torch.zeros(1, 1, 6, dtype=f64))[0]
        d1 = max((one_c.q.cpu() - one_h.q).abs().max().item(), (one_c.v.cpu() - one_h.v).abs().max().item())
        print(f"[loaders-world] golden cube_drop on the card leaves the golden at step {t_dev} (of 400): "
              f"|dq| {np.abs(qc[t_dev] - g['q'][t_dev]).max():.3e}; from the CPU port's state at step "
              f"{t_dev - 1}, one step on the card vs the CPU: max difference {d1:.3e} (limit 1e-9)")
        check(d1 <= 1e-9, "cube_drop: one step on the card differs from the CPU at the deviation")

    # IK, batched on the card against the CPU. Hierarchical IK's lower level
    # is chaotic in a few envs, in the JAX package as in the port
    # (scripts/torch_ik_chaos.py: a start moved by 1e-15 ends up to 4e2
    # apart after 80 iterations in 5 of these 64 envs, and 1e-14 apart in
    # the rest). A second CPU solve from such a moved start marks the stable
    # envs; on those the card's 80-iteration q and both levels' errors are
    # held to the CPU's, and one iteration on every env.
    Bi = 64
    rng = np.random.RandomState(14)
    levels = [[(5, (0, 0, 0))], [(2, (0, 0, 0))]]
    res = {}
    for dev in ("cuda", "cpu"):
        m4 = chain(n=4, length=0.3, dtype=f64, device=dev)
        m6 = chain(n=6, length=0.3, dtype=f64, device=dev)
        tg4 = fk(m4, torch.tensor(0.4 * np.random.RandomState(15).randn(Bi, 4), device=dev))[1][:, 3]
        p6 = fk(m6, torch.tensor(0.4 * np.random.RandomState(16).randn(Bi, 6), device=dev))[1]
        targets = [p6[:, 5][:, None], p6[:, 2][:, None]]
        zeros = torch.zeros(Bi, 6, dtype=f64, device=dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        q_ik, e_ik = solve_ik(m4, 3, tg4, torch.zeros(Bi, 4, dtype=f64, device=dev), iters=80)
        q_h, e_h = HierarchicalIK(m6, levels, iters=80).solve(targets, zeros)
        q_1 = HierarchicalIK(m6, levels, iters=1).solve(targets, zeros)[0]
        torch.cuda.synchronize()
        res[dev] = (q_ik.cpu(), e_ik.cpu(), q_h.cpu(), e_h.cpu(), q_1.cpu(), time.perf_counter() - t0)
    (qa, ea, qh, eh, q1, sec), (qa_c, ea_c, qh_c, eh_c, q1_c, _) = res["cuda"], res["cpu"]
    moved = zeros + 1e-15 * torch.tensor(np.random.RandomState(17).randn(Bi, 6))
    stable = (HierarchicalIK(m6, levels, iters=80).solve(targets, moved)[0] - qh_c).abs().amax(1) <= 1e-10
    d_ik = (qa - qa_c).abs().max().item()
    d_1 = (q1 - q1_c).abs().max().item()
    d_h = (qh - qh_c).abs().amax(1)
    d_e = (eh - eh_c).abs().amax(1)
    conv = int(((eh < 1e-6).all(1) & stable).sum())
    n_st = int(stable.sum())
    print(f"[loaders-world] IK on {card}, B={Bi} f64: solve_ik (4-link chain, 80 iterations) max error "
          f"{ea.max().item():.3e}, card vs CPU max |dq| {d_ik:.3e} (limit 1e-8); HierarchicalIK (6-link, "
          f"two levels): one iteration card vs CPU max |dq| {d_1:.3e} (limit 1e-10); 80 iterations: "
          f"{n_st} of {Bi} envs stable on the CPU (a start moved by 1e-15 ends within 1e-10), {conv} of "
          f"them with both levels converged (< 1e-6); card vs CPU on the stable envs max |dq| "
          f"{d_h[stable].max().item():.3e}, max |d error| {d_e[stable].max().item():.3e} (limit 1e-10); "
          f"on the other {Bi - n_st} envs max |dq| "
          f"{(d_h[~stable].max().item() if n_st < Bi else 0.0):.3e} (not held); the card's solves "
          f"{sec:.2f} s")
    check(ea.max().item() < 1e-5 and d_ik <= 1e-8, "solve_ik on the card differs from the CPU")
    check(d_1 <= 1e-10, "one HierarchicalIK iteration on the card differs from the CPU")
    check(n_st >= 0.85 * Bi, "HierarchicalIK is chaotic in more than 15% of the envs on the CPU")
    check(d_h[stable].max().item() <= 1e-10 and d_e[stable].max().item() <= 1e-10,
          "HierarchicalIK on the card differs from the CPU on a stable env")

    # the native Dantzig pivot solver (built here with g++) as the exact
    # oracle of the sweep kernel's solves at cube_drop contact states
    t0 = time.perf_counter()
    check(native_lcp.available(), "the native pivot solver does not build")
    build_s = time.perf_counter() - t0
    g = np.load(os.path.join(goldens, "cube_drop_f64.npz"))
    idx = np.nonzero(g["q"][:, 6] < 0.1005)[0]  # the cube within 0.5 mm of the ground
    sel = rng.choice(idx, Bg)
    q = torch.tensor(g["q"][sel]) + torch.tensor(1e-4 * rng.randn(Bg, 7))
    q[:, :4] = quat_normalize(q[:, :4])
    v = torch.tensor(g["v"][sel]) + torch.tensor(0.05 * rng.randn(Bg, 6))
    m = cube_drop(dt=2e-3, half=0.1, friction=0.5, restitution=0.3, dtype=f64,
                  device="cuda").replace(contact_solver="lowrank_pallas")
    reset_counts()
    with torch.no_grad():
        lcp, M, Minv, _, _ = prepare_constrained(m, State(q=q.cuda(), v=v.cuda()))
        lam = solve_contact_lcp(m, lcp, M)
    torch.cuda.synchronize()
    out["launches_native_oracle"] = P.KERNEL_SINGLE.launches
    resid = solve_residual(lam, lcp.A, lcp.b, lcp.lo, lcp.hi, lcp.mu, lcp.fidx).cpu().numpy()
    A, b, lo, hi, mu = (x.cpu().numpy() for x in (lcp.A, lcp.b, lcp.lo, lcp.hi, lcp.mu))
    fidx = lcp.fidx.cpu().numpy()
    J, Mi, lam_c = lcp.J.cpu().numpy(), Minv.cpu().numpy(), lam.cpu().numpy()
    err = np.full(Bg, np.inf)
    status = np.zeros(Bg, int)
    for e in range(Bg):
        x, _, status[e] = native_lcp.boxed_lcp_dantzig(A[e], b[e], lo[e], hi[e], mu[e], fidx)
        dv_k, dv_n = Mi[e] @ J[e].T @ lam_c[e], Mi[e] @ J[e].T @ x
        err[e] = np.abs(dv_k - dv_n).max() / max(1.0, np.abs(dv_n).max())
    exact = status == 0  # the pivot solver's own verdict: an exact solve
    within = err[exact] <= 1e-6
    print(f"[loaders-world] native pivot oracle (g++ build {build_s:.1f} s) at {Bg} cube_drop contact "
          f"states (D = {b.shape[1]}), the 'lowrank_pallas' solve ({out['launches_native_oracle']} sweep "
          f"launch): the pivot solve is exact on {int(exact.sum())} envs; there the velocity impulse "
          f"M^-1 J^T lam against the pivot solution's: {int(within.sum())} within 1e-6, max relative "
          f"{err[exact].max():.3e}, median {np.median(err[exact]):.3e} (lam itself is not unique where four "
          f"corners touch); the sweep kernel's natural-map residual < 1e-9 on {int((resid < 1e-9).sum())} "
          f"envs")
    check(out["launches_native_oracle"] == 1, "the oracle's solve missed the sweep kernel")
    check(exact.mean() >= 0.9, "the pivot solver is exact on fewer than 90% of the contact states")
    check(within.all(), "the sweep kernel's solves disagree with the pivot oracle")
    return out


DP_B, DP_T = 4096, 50  # phase 31: the half-cheetah's data-parallel BPTT


def dp_problem(device="cuda"):
    """Phase 31's data-parallel BPTT: the half-cheetah, float32, B = 4096,
    T = 50, standing start; the replicated params a shared control tape
    (T, nv), 0.1 N(0,1); per-env noise 0.1 N(0,1) in the batch (B, T, nv),
    both from numpy seeds, so every process makes the same numbers; the
    per-env loss q_T[:, 1]^2 + 1e-4 mean(tau^2), phase 9's loss per env.
    Returns (model, batch as a tree of host tensors, per_env, tape)."""
    from diffdart_tpu_torch.dynamics.model import State
    from diffdart_tpu_torch.models import cheetah_init_q, half_cheetah
    from diffdart_tpu_torch.sim.fast import rollout_fast

    m = half_cheetah(dt=2e-3, dtype=torch.float32, device=device)
    nv = m.nv
    noise = torch.tensor(0.1 * np.random.RandomState(31).randn(DP_B, DP_T, nv), dtype=torch.float32)
    tape = torch.tensor(0.1 * np.random.RandomState(32).randn(DP_T, nv), dtype=torch.float32,
                        device=device)
    batch = {"state": State(q=cheetah_init_q(m).cpu().repeat(DP_B, 1), v=torch.zeros(DP_B, nv)),
             "noise": noise}

    def per_env(tape_, b):
        taus = (tape_[None] + b["noise"]).transpose(0, 1)
        final = rollout_fast(m, b["state"], taus)
        return final.q[:, 1] ** 2 + 1e-4 * (taus**2).mean((0, 2))

    return m, batch, per_env, tape


def dp_child():
    """One process of phase 31(c), started by parallel_phase with DD_PID
    and DD_COORD set: joins a two-process gloo group, feeds its half of the
    batch (local_env_slice) on cuda:0, and prints one line "DP-CHILD
    {json}" with its loss, gradient and launches."""
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import torch.distributed as dist

    from diffdart_tpu_torch.ops import fused_step as fs
    from diffdart_tpu_torch.parallel import (
        data_parallel_grad, global_mesh, init_distributed, local_env_slice, make_global_batch,
        shutdown_distributed)
    from diffdart_tpu_torch.parallel.comm import tree_map

    pid = int(os.environ["DD_PID"])
    check(init_distributed(os.environ["DD_COORD"], 2, pid, backend="gloo"), "no process group")
    try:
        mesh = global_mesh(devices=["cuda:0", "cuda:0"])
        _, batch, per_env, tape = dp_problem()
        sl = local_env_slice(DP_B)
        sb = make_global_batch(mesh, tree_map(lambda x: x[sl], batch))
        fs.KERNEL.launches = fs.VJP_KERNEL.launches = 0
        t0 = time.perf_counter()
        loss, grad = data_parallel_grad(per_env, mesh)(tape, sb)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        print("DP-CHILD " + json.dumps({
            "pid": pid, "backend": dist.get_backend(), "device": str(sb.devices[0]),
            "rows": [sl.start, sl.stop], "loss": loss.item(),
            "grad": grad.flatten().tolist(), "launches": fs.KERNEL.launches,
            "launches_vjp": fs.VJP_KERNEL.launches, "seconds": secs}), flush=True)
    finally:
        shutdown_distributed()
    return 0


def free_port():
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def parallel_phase(card, reset_counts, kernel_ms, vjp_ms):
    """Phase 31: data-parallel BPTT on the card, (a) one process, one
    shard, (b) a one-rank NCCL group, (c) two gloo processes on the one
    card. Returns the kernel line's "parallel" entries."""
    import torch.distributed as dist

    from diffdart_tpu_torch.ops import fused_step as fs
    from diffdart_tpu_torch.parallel import (
        data_parallel_grad, init_distributed, make_mesh, shard_batch, shutdown_distributed)

    t_phase = time.perf_counter()
    B_, T_ = DP_B, DP_T
    _, batch, per_env, tape = dp_problem()
    # (a) one process, make_mesh(1) on cuda:0
    mesh = make_mesh(1)
    check(mesh.devices == (torch.device("cuda", 0),), f"make_mesh(1) gave {mesh.devices}")
    sb = shard_batch(mesh, batch)
    step = data_parallel_grad(per_env, mesh)
    reset_counts()
    loss_a, grad_a = step(tape, sb)
    torch.cuda.synchronize()
    launches_a = (fs.KERNEL.launches, fs.VJP_KERNEL.launches)

    def bare():
        x = tape.clone().requires_grad_(True)
        ref = per_env(x, sb.shards[0]).mean()
        ref.backward()
        return ref.detach(), x.grad

    ref_loss, ref_grad = bare()
    torch.cuda.synchronize()
    d_loss = (loss_a - ref_loss).abs().item()
    d_grad = (grad_a - ref_grad).abs().max().item()
    print(f"[parallel] (a) one process, make_mesh(1) = (cuda:0,), half-cheetah B={B_} T={T_} f32, "
          f"shared tape + per-env noise: {launches_a[0]} step and {launches_a[1]} VJP launches; loss "
          f"{loss_a.item():.9g}; against the same loss's plain backward(): |d loss| {d_loss:.3e}, "
          f"max |d grad| {d_grad:.3e} (max |grad| {ref_grad.abs().max().item():.3e}), bit for bit "
          f"{d_loss == 0 and d_grad == 0}")
    check(launches_a == (T_, T_), f"expected {T_} launches of each kernel, got {launches_a}")
    check(bool(torch.isfinite(grad_a).all()) and grad_a.abs().max().item() > 0, "bad gradient")
    check(d_loss == 0 and d_grad == 0, "the data-parallel step differs from the plain backward()")

    # (b) the same through a one-rank NCCL group: the all-reduce on the card
    port = free_port()
    check(init_distributed(f"127.0.0.1:{port}", num_processes=1, process_id=0, backend="nccl"),
          "init_distributed formed no group")
    try:
        backend = dist.get_backend()
        check(backend == "nccl", f"backend {backend}, not nccl")
        reset_counts()
        loss_b, grad_b = step(tape, sb)
        torch.cuda.synchronize()
        launches_b = (fs.KERNEL.launches, fs.VJP_KERNEL.launches)
        same_b = bool(torch.equal(loss_b, loss_a) and torch.equal(grad_b, grad_a))
        dp_ms = median_ms(lambda: step(tape, sb))
        bare_ms = median_ms(bare)
        buf = torch.zeros(grad_a.numel() + 2, device="cuda")
        ar_ms = median_ms(lambda: dist.all_reduce(buf), runs=21)
    finally:
        shutdown_distributed()
    print(f"[parallel] (b) one-rank {backend} group on 127.0.0.1:{port}: {launches_b[0]} step and "
          f"{launches_b[1]} VJP launches; loss and grad equal to (a) bit for bit: {same_b}; timing "
          f"on {card} (median of 5, CUDA events): data-parallel step {dp_ms[0]:.3f} ms ({dp_ms[1]:.3f}-"
          f"{dp_ms[2]:.3f}), bare BPTT (loss.mean().backward()) {bare_ms[0]:.3f} ms ({bare_ms[1]:.3f}-"
          f"{bare_ms[2]:.3f}); the layer's cost {dp_ms[0] - bare_ms[0]:.3f} ms "
          f"({100 * (dp_ms[0] - bare_ms[0]) / bare_ms[0]:.2f}%); one all_reduce of the "
          f"{buf.numel()} floats (loss, grad, count) {ar_ms[0]:.4f} ms (median of 21)")
    check(launches_b == (T_, T_), f"expected {T_} launches of each kernel, got {launches_b}")
    check(same_b, "the one-rank NCCL step differs from (a)")

    # (c) two processes on the one card: gloo (NCCL refuses two ranks on one device)
    port = free_port()
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--dp-child"],
        env=dict(os.environ, DD_PID=str(i), DD_COORD=f"127.0.0.1:{port}"),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True) for i in range(2)]
    outs = []
    t0 = time.perf_counter()
    try:
        for p in procs:
            outs.append(p.communicate(timeout=240) + (p.returncode,))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    wall_c = time.perf_counter() - t0
    kids = []
    for i, (out, err, rc) in enumerate(outs):
        check(rc == 0 and "DP-CHILD " in out,
              f"phase 31(c) process {i} failed (rc {rc}):\n{out[-2000:]}\n{err[-4000:]}")
        kids.append(json.loads(out.split("DP-CHILD ")[1].splitlines()[0]))
    g_a = grad_a.flatten().cpu().numpy().astype(np.float64)
    gmax = np.abs(g_a).max()
    for k in kids:
        g = np.array(k["grad"])
        k["rel_loss"] = abs(k["loss"] - loss_a.item()) / abs(loss_a.item())
        k["grad_err"] = np.abs(g - g_a).max()
    agree = kids[0]["loss"] == kids[1]["loss"] and kids[0]["grad"] == kids[1]["grad"]
    print(f"[parallel] (c) two processes on {card}, backend " + " / ".join(k["backend"] for k in kids)
          + " (explicit: NCCL refuses two ranks on one device), CUDA tensors passed to gloo's "
          "all_reduce as they are: " + "; ".join(
              f"process {k['pid']} rows {k['rows'][0]}-{k['rows'][1]} of {B_} on "
              f"{k['device']}: {k['launches']} step and {k['launches_vjp']} VJP launches, step "
              f"{k['seconds']:.2f} s (first call), loss relative error {k['rel_loss']:.3e}, max |d grad| "
              f"{k['grad_err']:.3e} ({k['grad_err'] / gmax:.3e} of max|g|)" for k in kids)
          + f"; the two agree bit for bit: {agree}; wall {wall_c:.1f} s")
    for k in kids:
        half = B_ // 2
        check(k["backend"] == "gloo" and k["rows"] == [k["pid"] * half, (k["pid"] + 1) * half],
              "phase 31(c): wrong group or batch")
        check(k["launches"] == T_ and k["launches_vjp"] == T_, f"phase 31(c): expected {T_} launches")
        check(k["rel_loss"] <= 1e-5 and k["grad_err"] <= 1e-5 * gmax,
              "phase 31(c): the two-process result differs from the full batch")
    check(agree, "phase 31(c): the two processes disagree")
    print(f"[parallel] phase 31: {time.perf_counter() - t_phase:.1f} s")
    return {"launches_one_process": launches_a[0], "launches_nccl_one_rank": launches_b[0],
            "launches_gloo_two_process": [k["launches"] for k in kids],
            "launches_vjp": {"one_process": launches_a[1], "nccl_one_rank": launches_b[1],
                             "gloo_two_process": [k["launches_vjp"] for k in kids]},
            "dp_ms": dp_ms[0], "bare_ms": bare_ms[0], "all_reduce_ms": ar_ms[0],
            "device_share_step": T_ * kernel_ms / dp_ms[0],
            "device_share_vjp": T_ * vjp_ms / dp_ms[0],
            "step": step, "sb": sb, "tape": tape}


def utils_phase(card, dp, m32, state, taus):
    """Phase 32: a device trace of one rollout_fast inside a named scope,
    in this process after phases 1-31 (device_trace checks that every
    kernel launch it records has its kernel event), and a checkpoint
    resume of phase 31's data-parallel Adam loop."""
    import tempfile

    from diffdart_tpu_torch.ops import fused_step as fs
    from diffdart_tpu_torch.sim.fast import rollout_fast
    from diffdart_tpu_torch.utils import restore_checkpoint, save_checkpoint
    from diffdart_tpu_torch.utils.profile import device_trace, named_scope

    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp, torch.no_grad():
        rollout_fast(m32, state, taus)  # warm
        torch.cuda.synchronize()
        fs.KERNEL.launches = 0
        with device_trace(tmp) as prof:
            with named_scope("rollout_fast_T50"):
                rollout_fast(m32, state, taus)
        launches = fs.KERNEL.launches
        size = os.path.getsize(prof.trace_path)
        with open(prof.trace_path) as f:
            events = json.load(f)["traceEvents"]
    kern = [e for e in events if e.get("cat") == "kernel" and "fused_step_kernel" in e.get("name", "")]
    kern_ms = sum(e.get("dur", 0) for e in kern) / 1e3
    scope_cats = sorted({e.get("cat") for e in events if e.get("name") == "rollout_fast_T50"})
    print(f"[utils] device_trace of rollout_fast (B={B}, T={T}, f32) in "
          f"named_scope('rollout_fast_T50'), in this process after phases 1-31: a {size} byte Chrome "
          f"trace; {prof.kernel_launches} kernel launches recorded (its closing kernel's included), "
          f"each with its kernel event; "
          f"{len(kern)} events named {sorted({e['name'] for e in kern})}, {kern_ms:.3f} ms of device "
          f"time ({kern_ms / max(len(kern), 1):.4f} ms each); the scope's events in categories "
          f"{scope_cats}; {launches} counted launches")
    check(len(kern) == T and launches == T, f"expected {T} step-kernel events in the trace")
    check("user_annotation" in scope_cats, "the trace does not name the scope")

    step, sb, tape0 = dp["step"], dp["sb"], dp["tape"]

    def fresh():
        p = torch.nn.Parameter(tape0.clone())
        return p, torch.optim.Adam([p], lr=0.05)

    def run(p, opt, n):
        losses = []
        for _ in range(n):
            loss, g = step(p.detach(), sb)
            p.grad = g
            opt.step()
            losses.append(loss.item())
        return losses

    p, opt = fresh()
    straight = run(p, opt, 5)
    with tempfile.TemporaryDirectory() as tmp:
        pa, opta = fresh()
        first = run(pa, opta, 3)
        fname = save_checkpoint(tmp, {"tape": pa, "opt": opta.state_dict(), "step": 3}, step=3)
        pb, optb = fresh()
        ck = restore_checkpoint(fname, like={"tape": pb, "opt": optb.state_dict()})
        on_card = ck["tape"].device.type == "cuda"
        with torch.no_grad():
            pb.copy_(ck["tape"])
        optb.load_state_dict(ck["opt"])
        second = run(pb, optb, 2)
    same = bool(torch.equal(pb, p))
    d = (pb - p).abs().max().item()
    print(f"[utils] checkpoint resume of phase 31's data-parallel Adam loop (lr 0.05): losses "
          f"{[f'{x:.6g}' for x in straight]} straight, {[f'{x:.6g}' for x in first + second]} with "
          f"save after 3 ({os.path.basename(fname)}), restored on the card {on_card}; the tape after "
          f"5 steps equal bit for bit: {same} (max |d| {d:.3e})")
    check(on_card and ck["step"] == 3, "the checkpoint did not restore onto the card")
    check(same and first + second == straight, "the resumed run differs from the straight run")
    print(f"[utils] phase 32: {time.perf_counter() - t_phase:.1f} s")


def viewer_phase(card, m32, state, taus):
    """Phase 33: frames of a card rollout against the same q on the CPU,
    then the WebSocket server streaming them to a raw-socket client."""
    import base64
    import socket
    import struct
    import threading

    from diffdart_tpu_torch.dynamics.model import State
    from diffdart_tpu_torch.models import half_cheetah
    from diffdart_tpu_torch.sim.fast import rollout_fast
    from diffdart_tpu_torch.viewer import GUIWebsocketServer, state_frame, trajectory_frames

    t_phase = time.perf_counter()
    T_ = taus.shape[0]
    qs = []
    st = state
    with torch.no_grad():
        for t in range(T_):
            st = rollout_fast(m32, st, taus[t:t + 1])
            qs.append(st.q[0])
    qs = torch.stack(qs)

    def units(fa_, fb_):
        """Largest difference of two frame lists in units of the fifth
        place (both round to 5 places; float32 values carry their own
        representation error, so a one-unit flip reads up to ~1.01e-5)."""
        return max(round(abs(a - b) * 1e5) for x, y in zip(fa_, fb_)
                   for pa, pb in zip(x["poses"], y["poses"])
                   for a, b in zip(pa["pos"] + pa["quat"], pb["pos"] + pb["quat"]))

    trajectory_frames(m32, qs)  # warm
    t0 = time.perf_counter()
    card_frames = trajectory_frames(m32, qs)
    ms_traj = 1e3 * (time.perf_counter() - t0)
    m_cpu = half_cheetah(dt=2e-3, dtype=torch.float32, device="cpu")
    cpu_frames = trajectory_frames(m_cpu, qs.cpu())
    n_diff = sum(a != b for x, y in zip(card_frames, cpu_frames)
                 for pa, pb in zip(x["poses"], y["poses"])
                 for a, b in zip(pa["pos"] + pa["quat"], pb["pos"] + pb["quat"]))
    err = units(card_frames, cpu_frames)
    one = units([state_frame(m32, qs[-1], t=0.1)], [state_frame(m_cpu, qs[-1].cpu(), t=0.1)])
    print(f"[viewer] half-cheetah f32, env 0 of a card rollout (B={state.q.shape[0]}, T={T_}): "
          f"trajectory_frames on the card {ms_traj:.2f} ms for {T_} frames (warm); against the same "
          f"q on the CPU {n_diff} of {T_ * m32.ngeom * 7} numbers differ, by at most {err} unit(s) "
          f"in the fifth place (limit 1); the last state_frame: {one}")
    check(len(card_frames) == T_ and err <= 1 and one <= 1, "card frames differ from the CPU's")

    srv = GUIWebsocketServer().serve(port=0, host="127.0.0.1")
    msgs, errs = [], []

    def reader(c):
        buf = b""
        try:
            while len(msgs) < T_ + 1:
                chunk = c.recv(65536)
                if not chunk:
                    break
                buf += chunk
                while len(buf) >= 2:
                    n, off = buf[1] & 0x7F, 2
                    if n == 126:
                        n, off = struct.unpack("!H", buf[2:4])[0], 4
                    elif n == 127:
                        n, off = struct.unpack("!Q", buf[2:10])[0], 10
                    if len(buf) < off + n:
                        break
                    msgs.append(json.loads(buf[off:off + n].decode()))
                    buf = buf[off + n:]
        except (OSError, ValueError) as e:
            errs.append(repr(e))

    connected = threading.Event()
    srv.registerConnectionListener(connected.set)
    try:
        c = socket.create_connection(("127.0.0.1", srv.port), timeout=10)
        key = base64.b64encode(os.urandom(16)).decode()
        c.sendall(("GET / HTTP/1.1\r\nHost: x\r\nUpgrade: websocket\r\nConnection: Upgrade\r\n"
                   f"Sec-WebSocket-Key: {key}\r\nSec-WebSocket-Version: 13\r\n\r\n").encode())
        check(b"101" in c.recv(4096), "no WebSocket handshake")
        check(connected.wait(10), "the server did not register the client")
        th = threading.Thread(target=reader, args=(c,), daemon=True)
        th.start()
        t0 = time.perf_counter()
        for t in range(T_):
            srv.renderWorld(m32, qs[t], t=t * float(m32.dt))
        send_ms = 1e3 * (time.perf_counter() - t0)
        th.join(timeout=30)
        c.close()
    finally:
        srv.stop()
    kinds = [x["kind"] for x in msgs]
    streamed = [x for x in msgs if x["kind"] == "frame"]
    err_s = units(streamed, card_frames) if streamed else 0
    print(f"[viewer] GUIWebsocketServer on 127.0.0.1:{srv.port}: a raw-socket client in this process "
          f"parsed {kinds.count('scene')} scene and {len(streamed)} frame messages ({errs or 'no error'}); "
          f"renderWorld x {T_} from card states {send_ms:.1f} ms ({send_ms / T_:.2f} ms per frame); "
          f"against trajectory_frames' at most {err_s} unit(s) in the fifth place")
    check(not th.is_alive() and not errs, "the WebSocket client did not finish")
    check(kinds == ["scene"] + ["frame"] * T_ and err_s <= 1,
          "the stream is not the scene and the T frames")
    print(f"[viewer] phase 33: {time.perf_counter() - t_phase:.1f} s")


def bridge_phase(card, reset_counts):
    """Phase 34: torch_bridge.timestep on cube_drop with 'lowrank_pallas',
    float64, 20 steps on the card against the CPU port. Returns the sweep
    launches of the card's chain."""
    from diffdart_tpu_torch.models import cube_drop
    from diffdart_tpu_torch.ops import pallas_lcp as P
    from diffdart_tpu_torch.torch_bridge import timestep

    t_phase = time.perf_counter()
    f64 = torch.float64
    out = {}
    for dev in ("cuda", "cpu"):
        m = cube_drop(dt=2e-3, half=0.1, friction=0.5, dtype=f64,
                      device=dev).replace(contact_solver="lowrank_pallas")
        q = m.neutral_q()
        q[6] = 0.105
        v0 = torch.tensor([0.3, -0.2, 0.1, 1.0, 0.2, 0.0], dtype=f64, device=dev, requires_grad=True)
        tau = torch.zeros(6, dtype=f64, device=dev)
        v = v0
        reset_counts()
        if dev == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(20):
            q, v = timestep(m, q, v, tau)
        (q[4] + q[5] + q[6]).backward()
        if dev == "cuda":
            torch.cuda.synchronize()
        out[dev] = (q.detach().cpu(), v.detach().cpu(), v0.grad.cpu(), P.KERNEL_SINGLE.launches,
                    time.perf_counter() - t0)
    (qc, vc_, gc, lc, sc_), (qh, vh, gh, lh, sh) = out["cuda"], out["cpu"]
    dq, dv = (qc - qh).abs().max().item(), (vc_ - vh).abs().max().item()
    rel_g = ((gc - gh).abs().max() / gh.abs().max()).item()
    print(f"[bridge] torch_bridge.timestep, cube_drop f64 'lowrank_pallas', 20 steps landing on its "
          f"contacts (z 0.105, v0 {[0.3, -0.2, 0.1, 1.0, 0.2, 0.0]}): {lc} jacobi_sweeps_single launches "
          f"on the card ({lh} on the CPU); card vs CPU max |dq| {dq:.3e}, |dv| {dv:.3e} (limit 1e-9); "
          f"d(q4+q5+q6)/dv0 {[f'{x:.6g}' for x in gc.tolist()]}, relative difference {rel_g:.3e} "
          f"(limit 1e-8); 20 steps + backward {1e3 * sc_:.1f} ms on the card, {1e3 * sh:.1f} ms on "
          f"the CPU")
    check(lc == 20 and lh == 0, f"expected 20 sweep launches on the card, got {lc}")
    check(dq <= 1e-9 and dv <= 1e-9, "the bridge's card step differs from the CPU's")
    check(bool(torch.isfinite(gc).all()) and rel_g <= 1e-8, "the bridge's card gradient differs")
    print(f"[bridge] phase 34: {time.perf_counter() - t_phase:.1f} s")
    return lc


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    # Kineto stops CUPTI after every profiler trace (phases 23, 26 and 32
    # trace): a CUPTI left running drifts from the host clock as the process
    # ages and its traces lose kernel events (utils/profile.py).
    os.environ.setdefault("TEARDOWN_CUPTI", "1")
    if sys.argv[1:] == ["--dp-child"]:
        return dp_child()
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from concurrent.futures import ThreadPoolExecutor

    from diffdart_tpu_torch.dynamics.model import State
    from diffdart_tpu_torch.models import cheetah_init_q, half_cheetah
    from diffdart_tpu_torch.ops import fused_step as fs
    from diffdart_tpu_torch.ops import pallas_lcp as P
    from diffdart_tpu_torch.ops import sweep_check as sc
    from diffdart_tpu_torch.ops import vjp_check as vc
    from diffdart_tpu_torch.sim.fast import rollout_fast

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # ---- 1. device ----
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    print(f"[device] {card} | torch {torch.__version__} | CUDA {torch.version.cuda} | {kind}")

    # ---- 2. build (every source at once, one nvcc each) ----
    t0 = time.perf_counter()
    with ThreadPoolExecutor(3) as pool:
        lib, lib_sw, _ = pool.map(lambda load: load[0](load[1]),
                                  ((fs._load, "cuda"), (P._load, "cuda"), (P._load, "host")))
    build_wall = time.perf_counter() - t0

    def ptxas(lib):
        return "; ".join(f"{k}: {v}" for k, v in ptxas_lines(lib).items())

    print(f"[build] fused_step.cu: nvcc {lib.build_seconds:.1f} s ({build_wall:.1f} s for both sources "
          f"in parallel) | ptxas: {ptxas(lib)}")
    check(all(k in ptxas_lines(lib) for k in ("fused_step<float>", "fused_step_vjp<float>")),
          "no ptxas report of the step and VJP kernels")
    m64 = half_cheetah(dt=2e-3, dtype=torch.float64, device="cuda")
    m32 = half_cheetah(dt=2e-3, dtype=torch.float32, device="cuda")
    step64, step32 = fs.build_fused_step(m64), fs.build_fused_step(m32)
    D, nv = step32.D, m32.nv
    occ = {dt: fs.occupancy("cuda", dt, D, nv) for dt in (torch.float32, torch.float64)}
    print("[build] step kernel, one warp per env, " + "; ".join(
        f"{str(dt)[6:]}: {o['env_bytes']} bytes of shared memory per env (one warp, one block), "
        f"{o['warps_per_sm']} warps per SM" for dt, o in occ.items())
        + f" (half-cheetah, D = {D}, nv = {nv})")
    check(all(o["warps_per_sm"] > 0 for o in occ.values()), "the step kernel fits no block on an SM")

    rng = np.random.RandomState(0)
    q0 = cheetah_init_q(m64).cpu().numpy()
    q_np = np.tile(q0, (B, 1)) + 0.02 * rng.randn(B, m64.nq)
    v_np = 0.2 * rng.randn(B, m64.nv)
    tau_np = 0.5 * rng.randn(B, m64.nv)

    def soa(x, dtype):
        return torch.tensor(np.ascontiguousarray(x.T), dtype=dtype, device="cuda")

    # ---- 3. float64 parity, 20 re-synced steps ----
    q, v, tau = soa(q_np, torch.float64), soa(v_np, torch.float64), soa(tau_np, torch.float64)
    eq = ev = 0.0
    with torch.no_grad():
        for _ in range(20):
            qk, vk = step64(q, v, tau)
            qp, vp = step64.plain(q, v, tau)
            torch.cuda.synchronize()
            eq = max(eq, (qk - qp).abs().max().item())
            ev = max(ev, (vk - vp).abs().max().item())
            q, v = qp, vp
    print(f"[f64] 20 re-synced steps at B={B}: max |dq| {eq:.3e} (tol 1e-8), max |dv| {ev:.3e} (tol 1e-7)")
    check(eq <= 1e-8 and ev <= 1e-7, "float64 kernel disagrees with the plain version")

    # ---- 4. float32 parity, one step ----
    q, v, tau = soa(q_np, torch.float32), soa(v_np, torch.float32), soa(tau_np, torch.float32)
    with torch.no_grad():
        qk, vk = step32(q, v, tau)
        qp, vp = step32.plain(q, v, tau)
    torch.cuda.synchronize()
    dq, dv = (qk - qp).abs().amax(0), (vk - vp).abs().amax(0)
    within = ((dq <= 1e-4) & (dv <= 5e-2)).float().mean().item()
    f32_err = max(dq.max().item(), dv.max().item())
    print(f"[f32] one step at B={B}: |dq| max {dq.max().item():.3e} p99 {dq.quantile(0.99).item():.3e}, "
          f"|dv| max {dv.max().item():.3e} p99 {dv.quantile(0.99).item():.3e}; "
          f"{100 * within:.2f}% of envs within q 1e-4, v 5e-2")
    check(bool(torch.isfinite(qk).all() and torch.isfinite(vk).all()), "non-finite float32 output")
    check(within >= 0.99, "float32 kernel disagrees with the plain version on > 1% of envs")

    # ---- 5. main path: rollout_fast, B = 4096, T = 50, float32 ----
    q_main = cheetah_init_q(m32).repeat(B, 1)
    taus = torch.tensor(0.1 * np.random.RandomState(1).randn(T, B, m32.nv), dtype=torch.float32,
                        device="cuda")
    state = State(q=q_main, v=torch.zeros(B, m32.nv, device="cuda"), t=torch.zeros(B, device="cuda"))
    with torch.no_grad():
        fs.KERNEL.launches = 0
        final = rollout_fast(m32, state, taus)
        torch.cuda.synchronize()
        launches = fs.KERNEL.launches
    z = final.q[:, 0]
    print(f"[main] rollout_fast B={B} T={T} f32: {launches} kernel launches; final torso z "
          f"min {z.min().item():.4f} max {z.max().item():.4f}; finite "
          f"{bool(torch.isfinite(final.q).all() and torch.isfinite(final.v).all())}")
    check(launches == T, f"expected {T} kernel launches on the main path, got {launches}")
    check(tuple(final.q.shape) == (B, m32.nq) and tuple(final.v.shape) == (B, m32.nv), "bad shapes")
    check(bool(torch.isfinite(final.q).all() and torch.isfinite(final.v).all()), "non-finite final state")
    check(bool(((z > 0.0) & (z < 1.0)).all()), "implausible torso height")

    with torch.no_grad():
        qs, vs, ts = fs.to_soa(q_main), torch.zeros(m32.nv, B, device="cuda"), taus[0].T.contiguous()
        desc32 = step32.descriptor(qs.device, torch.float32)
        wrapped_ms = cuda_ms(lambda: step32(qs, vs, ts), reps=50)
        kernel_ms, kernel_issue_ms, _ = step_device_ms(lib, desc32, D, qs, vs, ts)
        front_ms, _, (_, vstar, _) = step_device_ms(lib, desc32, D, qs, vs, ts, front_only=True)
        plain_ms = cuda_ms(lambda: step32.plain(qs, vs, ts), reps=3)
        roll_ms = cuda_ms(lambda: rollout_fast(m32, state, taus), reps=3)

        def uncached_rollout():
            fs._STEPS.clear()  # as every call was before the per-model cache
            rollout_fast(m32, state, taus)

        roll_uncached_ms = cuda_ms(uncached_rollout, reps=3)
    sps = B * T / (roll_ms * 1e-3)
    print(f"[main] timing on {card}: step kernel {kernel_ms:.4f} ms/launch on the device (one warp "
          f"per env; issuing one launch {kernel_issue_ms:.4f} ms on the host; through the wrapper "
          f"{wrapped_ms:.4f} ms/step; one thread per env, the earlier design: 0.8484 ms on an "
          f"NVIDIA H100 80GB HBM3 at 700 W); the launch that stops after the front end "
          f"{front_ms:.4f} ms = {100 * front_ms / kernel_ms:.1f}% of it; rollout {roll_ms:.3f} ms = "
          f"{roll_ms / T:.4f} ms/step = {sps:.6g} env-steps/s forward; plain version "
          f"{plain_ms:.2f} ms/step (context only)")
    check(kernel_issue_ms < kernel_ms, "the step kernel's timing waited on the host")
    check(bool(torch.isfinite(vstar).all()), "non-finite v* from the front end's launch")
    print(f"[main] host set-up, rollout - {T} x kernel: {roll_ms - T * kernel_ms:.3f} ms with the "
          f"per-model FusedStep cache, {roll_uncached_ms - T * kernel_ms:.3f} ms with the cache "
          f"cleared before each rollout (rollout {roll_uncached_ms:.3f} ms)")

    # ---- 6. reference check: float64 rollout, kernel vs plain version ----
    Br = 256
    st64 = State(q=cheetah_init_q(m64).repeat(Br, 1), v=torch.zeros(Br, m64.nv, dtype=torch.float64, device="cuda"))
    taus64 = taus[:, :Br].double()
    with torch.no_grad():
        ker = rollout_fast(m64, st64, taus64)
        qp, vp = fs.to_soa(st64.q), fs.to_soa(st64.v)
        for t in range(T):
            qp, vp = step64.plain(qp, vp, taus64[t].T.contiguous())
    eq_r = (ker.q - qp.T).abs().amax(1)
    ev_r = (ker.v - vp.T).abs().amax(1)
    frac = ((eq_r <= 1e-6) & (ev_r <= 1e-4)).double().mean().item()
    print(f"[reference] f64 rollout B={Br} T={T}: max |dq| {eq_r.max().item():.3e}, "
          f"max |dv| {ev_r.max().item():.3e}; {100 * frac:.2f}% of envs within q 1e-6, v 1e-4")
    check(frac >= 0.99, "float64 rollout through the kernel disagrees with the plain version")

    # ---- 7. grad64: VJP kernel vs plain autograd, one float64 step ----
    rng_g = np.random.RandomState(2)
    gq_np, gv_np = rng_g.randn(B, m64.nq), rng_g.randn(B, m64.nv)
    q, v, tau, gq, gv = (soa(x, torch.float64) for x in (q_np, v_np, tau_np, gq_np, gv_np))
    d64 = fs.VJP_KERNEL(*step64.descriptor(q.device, torch.float64), q, v, tau, gq, gv,
                        step64.tape_capacity(q, v, tau), primal=True)
    with torch.no_grad():
        qk, vk = step64(q, v, tau)
    xs = [x.clone().requires_grad_(True) for x in (q, v, tau)]
    want64 = torch.autograd.grad(step64.plain(*xs), xs, (gq, gv))
    torch.cuda.synchronize()
    share64, rel64 = vc.envs_within(d64[:3], want64), vc.env_rel_err(d64[:3], want64)
    finite64 = all(bool(torch.isfinite(x).all()) for x in d64[:3])
    primal_eq = bool(torch.equal(d64[3], qk) and torch.equal(d64[4], vk))
    err64 = max((a - b).abs().max().item() for a, b in zip(d64[:3], want64))
    print(f"[grad64] VJP one step at B={B}: {100 * share64:.2f}% of envs within rtol 1e-6 + "
          f"atol 1e-8 max|g|; env relative error median {rel64.median().item():.3e}, p99 "
          f"{rel64.quantile(0.99).item():.3e}, max {rel64.max().item():.3e}; max |d| {err64:.3e}; "
          f"finite {finite64}; step kernel output == the tape's primal (serial solve) on all "
          f"{B} envs: {primal_eq}")
    check(finite64, "non-finite float64 VJP")
    check(primal_eq, "the VJP kernel's primal differs from kernel 1's output")
    check(share64 >= vc.VJP_SHARE, "float64 VJP kernel disagrees with plain autograd on > 1% of envs")

    # ---- 8. grad32: the same step in float32 against reverse-mode autograd ----
    q, v, tau, gq, gv = (soa(x, torch.float32) for x in (q_np, v_np, tau_np, gq_np, gv_np))
    cap32 = step32.tape_capacity(q, v, tau)
    *d32, q32p, v32p = fs.VJP_KERNEL(*step32.descriptor(q.device, torch.float32), q, v, tau, gq, gv,
                                     cap32, primal=True)
    with torch.no_grad():
        qk, vk = step32(q, v, tau)
    rev32 = vc.reverse_mode_vjp(step32.plain, q, v, tau, gq, gv)
    fwd32 = vc.forward_mode_vjp(step32.plain, q, v, tau, gq, gv)
    torch.cuda.synchronize()
    med32, share32, rel32 = vc.f32_stats(d32, rev32)
    med_fwd, share_fwd, _ = vc.f32_stats(fwd32, rev32)
    finite32 = all(bool(torch.isfinite(x).all()) for x in d32)
    vjp32_err = max((a - b).abs().max().item() for a, b in zip(d32, rev32))
    exact32 = (rel32 == 0).double().mean().item()
    print(f"[grad32] VJP one step at B={B} against reverse-mode autograd of the plain float32 step: "
          f"env relative error median {med32:.3e}, p99 {rel32.quantile(0.99).item():.3e}, "
          f"{100 * share32:.2f}% of envs within {vc.F32_REL:g}, {100 * exact32:.2f}% equal, max |d| "
          f"{vjp32_err:.3e}; finite {finite32}; plain forward mode against it (context): median "
          f"{med_fwd:.3e}, {100 * share_fwd:.2f}% within {vc.F32_REL:g}")
    primal_eq32 = bool(torch.equal(q32p, qk) and torch.equal(v32p, vk))
    print(f"[grad32] step kernel output == the tape's primal (serial solve) on all {B} envs: "
          f"{primal_eq32}")
    check(primal_eq32, "the VJP kernel's float32 primal differs from kernel 1's output")
    check(finite32, "non-finite float32 VJP")
    check(vc.f32_ok(med32, share32),
          f"float32 VJP kernel disagrees with reverse-mode autograd of the plain version (median > "
          f"{vc.F32_MEDIAN:g} or < {100 * vc.F32_SHARE:g}% of envs within {vc.F32_REL:g})")
    nodes32 = fs.VJP_KERNEL.tape_nodes(*step32.descriptor(q.device, torch.float32), q, v, tau)
    check(fs.tape_capacity(nodes32) == cap32, "tape capacity is not the counted nodes plus margin")
    per_env = fs.tape_bytes(torch.float32, nodes32, 1)
    print(f"[tape] half-cheetah float32: {nodes32} nodes per env (capacity {cap32}), {per_env} bytes "
          f"per env, {fs.tape_bytes(torch.float32, nodes32, B) / 1e6:.3f} MB per launch at B={B} "
          f"({fs.tape_bytes(torch.float32, cap32, B) / 1e6:.3f} MB allocated)")

    # ---- 9. bptt, the main path of training: rollout_fast + backward ----
    def bptt(model, st, taus_in):
        taus_g = taus_in.clone().requires_grad_(True)
        fin = rollout_fast(model, st, taus_g)
        loss = (fin.q[:, 1] ** 2).mean() + 1e-4 * (taus_g**2).mean()
        loss.backward()
        return taus_g.grad

    fs.KERNEL.launches = fs.VJP_KERNEL.launches = fs.VJP_KERNEL.self_solved = 0
    dtaus = bptt(m32, state, taus)
    torch.cuda.synchronize()
    launches_fwd, launches_vjp = fs.KERNEL.launches, fs.VJP_KERNEL.launches
    self_solved = fs.VJP_KERNEL.self_solved
    # the regulariser's gradient by itself: exactly what autograd adds to the
    # part through the kernels, so the difference is that part (0 if the
    # kernels gave 0)
    taus_r = taus.clone().requires_grad_(True)
    (g_reg,) = torch.autograd.grad(1e-4 * (taus_r**2).mean(), taus_r)
    d_dyn = dtaus - g_reg
    share_dyn = (d_dyn != 0).any(-1).any(0).double().mean().item()
    print(f"[bptt] rollout_fast + backward B={B} T={T} f32: {launches_fwd} step and {launches_vjp} "
          f"VJP launches, {self_solved} of them solving the LCP again; |dtau| max {dtaus.abs().max().item():.3e}, finite "
          f"{bool(torch.isfinite(dtaus).all())}; part through the kernels: |dtau| max "
          f"{d_dyn.abs().max().item():.3e}, non-zero on {100 * share_dyn:.2f}% of envs "
          f"(regulariser's |dtau| max {g_reg.abs().max().item():.3e})")
    check(launches_fwd == T and launches_vjp == T,
          f"expected {T} step and {T} VJP launches on the BPTT path, got {launches_fwd}, {launches_vjp}")
    check(self_solved == 0, f"{self_solved} VJP launches of the BPTT solved the LCP again")
    check(bool(torch.isfinite(dtaus).all()) and share_dyn >= 0.99, "bad BPTT gradient")
    bptt(m32, state, taus)
    bptt_runs = sorted(cuda_ms(lambda: bptt(m32, state, taus), reps=1) for _ in range(5))
    bptt_ms = bptt_runs[2]
    sps_grad = B * T / (bptt_ms * 1e-3)
    gqs, gvs = torch.ones_like(qs), torch.ones_like(vs)
    # the VJP's parts at the forward's saved LCP solution (the BPTT's launch),
    # then solving the LCP itself (every launch before the saved solution)
    with torch.no_grad():
        _, _, (_, _, sol32) = step_device_ms(lib, desc32, D, qs, vs, ts, reps=1, solution=True)
    parts = {}
    for name, sol in (("saved", sol32), ("solving", None)):
        for part in ("whole", "record", "count"):
            parts[name, part] = vjp_device_ms(lib, desc32, qs, vs, ts, gqs, gvs, cap32, part=part,
                                              solution=sol)
    vjp_ms, vjp_issue_ms = parts["saved", "whole"]
    record_ms, count_ms = parts["saved", "record"][0], parts["saved", "count"][0]
    solving_ms, solving_record_ms, solving_count_ms = (parts["solving", p][0]
                                                       for p in ("whole", "record", "count"))
    shared = torch.zeros(2, dtype=torch.int32, device="cuda")  # as a backward pass shares one
    vjp_wrap_ms = host_ms(lambda: fs.VJP_KERNEL(*desc32, qs, vs, ts, gqs, gvs, cap32, status=shared,
                                                solution=sol32), reps=10)
    fs.check_tape(shared, cap32)

    def plain_vjp():
        xs = [x.clone().requires_grad_(True) for x in (qs, vs, ts)]
        torch.autograd.grad(step32.plain(*xs), xs, (gqs, gvs))

    plain_vjp_ms = cuda_ms(plain_vjp, reps=1)
    print(f"[bptt] timing on {card}: VJP kernel at the saved LCP solution {vjp_ms:.4f} ms/launch on "
          f"the device (issuing one launch {vjp_issue_ms:.4f} ms on the host; one wrapper call as the "
          f"backward pass makes it {vjp_wrap_ms:.4f} ms of host time); its parts on the device: "
          f"counting launch (the recording's arithmetic, no tape) {count_ms:.4f} ms, recording with "
          f"its tape, no sweep {record_ms:.4f} ms, so the tape's stores {record_ms - count_ms:.4f} ms "
          f"and the sweep {vjp_ms - record_ms:.4f} ms; solving the LCP itself: whole {solving_ms:.4f}, "
          f"recording {solving_record_ms:.4f}, counting {solving_count_ms:.4f} ms, so the serial "
          f"solve {solving_count_ms - count_ms:.4f} ms "
          f"({100 * (solving_count_ms - count_ms) / solving_count_ms:.1f}% of the counting launch); "
          f"loss + backward median {bptt_ms:.3f} ms (min "
          f"{bptt_runs[0]:.3f}, max {bptt_runs[-1]:.3f}, 5 runs) = {sps_grad:.6g} fwd+grad "
          f"env-steps/s; plain VJP (forward with graph + backward) {plain_vjp_ms:.2f} ms/step "
          f"(context only)")
    check(vjp_issue_ms < vjp_ms, "the VJP kernel's timing waited on the host")

    # ---- 10. bptt-reference: float64, B = 256, T = 10, kernels vs plain ----
    Tr = 10
    taus_k = taus64[:Tr].clone().requires_grad_(True)
    (rollout_fast(m64, st64, taus_k).q[:, 1] ** 2).mean().backward()
    dt_ker = taus_k.grad
    taus_p = taus64[:Tr].clone().requires_grad_(True)
    qp, vp = fs.to_soa(st64.q), fs.to_soa(st64.v)
    for t in range(Tr):
        qp, vp = step64.plain(qp, vp, taus_p[t].T.contiguous())
    (qp[1] ** 2).mean().backward()
    dt_pl = taus_p.grad
    ok_env = ((dt_ker - dt_pl).abs() <= 1e-5 * dt_pl.abs() + 1e-8 * dt_pl.abs().max()).all(0).all(-1)
    frac_g = ok_env.double().mean().item()
    print(f"[bptt-reference] f64 B={Br} T={Tr}, d mean(q_T[:, 1]^2) / dtau: max |difference| "
          f"{(dt_ker - dt_pl).abs().max().item():.3e} of max |dtau| {dt_pl.abs().max().item():.3e}; "
          f"{100 * frac_g:.2f}% of envs within rtol 1e-5")
    check(bool(dt_pl.abs().max() > 0), "zero reference gradient")
    check(frac_g >= 0.99, "float64 BPTT gradient through the kernels disagrees with the plain version")

    # ---- 11. build of the sweep kernel (started with the others in phase 2) ----
    print(f"[build] jacobi_sweeps.cu: nvcc {lib_sw.build_seconds:.1f} s | ptxas: {ptxas(lib_sw)}")
    sw_cfg = {dt: P.launch_config(dt, D) for dt in (torch.float32, torch.float64)}
    print("[build] sweep kernel, one warp per env: " + "; ".join(
        f"{str(dt)[6:]}: {c['warp_bytes']} bytes of shared memory per warp "
        f"({'the register path' if c['register_path'] else 'the direct path'}), "
        f"{c['warps_per_block']} warps per block ({c['block_bytes']} bytes), "
        f"{c['warps_per_sm']} warps per SM" for dt, c in sw_cfg.items()) + f" (D = {D})")
    check(all(c["warps_per_sm"] > 0 for c in sw_cfg.values()), "the sweep kernel fits no block on an SM")

    from diffdart_tpu_torch.ops.lcp import _jacobi
    from diffdart_tpu_torch.sim import step as S
    from diffdart_tpu_torch.sim.batched import step_batched
    from diffdart_tpu_torch.sim.constrained import prepare_constrained, solver_diagnostics

    def reset_counts():
        fs.KERNEL.launches = fs.VJP_KERNEL.launches = 0
        P.KERNEL.launches = P.KERNEL_SINGLE.launches = 0

    def bs(x, dtype):  # (B, k) numpy -> batch-first tensor on the card
        return torch.tensor(x, dtype=dtype, device="cuda")

    # ---- 12. sweeps64 / sweeps32: kernel vs _jacobi on real half-cheetah LCPs ----
    lcps = {}
    sweep_errs = {}
    for dtype, m_ in ((torch.float64, m64), (torch.float32, m32)):
        with torch.no_grad():
            lcp = prepare_constrained(m_, State(q=bs(q_np, dtype), v=bs(v_np, dtype)), bs(tau_np, dtype))[0]
        lcps[dtype] = lcp
        args = (lcp.A, lcp.b, lcp.lo, lcp.hi, lcp.mu)
        for Bc in (B, 13):
            got = P.jacobi_sweeps_pallas(*(x[:Bc] for x in args), lcp.fidx, m_.contact_iters)
            want = _jacobi(*(x[:Bc] for x in args), lcp.fidx, m_.contact_iters)
            torch.cuda.synchronize()
            err, rel = sc.sweep_error(got, want)
            name = "sweeps64" if dtype == torch.float64 else "sweeps32"
            print(f"[{name}] B={Bc} D={lcp.b.shape[-1]} iters={m_.contact_iters}: max |dlam| {err:.3e}, "
                  f"max relative {rel:.3e} (limit {sc.REL_F64 if dtype == torch.float64 else sc.REL_F32:g}); "
                  f"finite {bool(torch.isfinite(got).all())}; max |lam| {want.abs().max().item():.3e}")
            check(sc.sweep_ok(got, want), f"{name}: the sweep kernel disagrees with _jacobi at B={Bc}")
            sweep_errs[dtype, Bc] = err
            host = P.host_sweeps(*(x[:Bc] for x in args), lcp.fidx, m_.contact_iters, dtype=dtype)
            exact = bool(torch.equal(got.cpu(), host))
            print(f"[{name}] B={Bc}: kernel lam == host build's lam bit for bit: {exact}")
            check(exact, f"{name}: the sweep kernel differs from its host build at B={Bc}")

    # ---- 13. vmap-step: the vmap step through the sweep kernel vs the fused step kernel ----
    m64p = m64.replace(contact_solver="lowrank_pallas", lcp_pivot_iters=0)
    q, v, tau = bs(q_np, torch.float64), bs(v_np, torch.float64), bs(tau_np, torch.float64)
    flips = 0
    eq = ev = 0.0
    with torch.no_grad():
        for _ in range(20):
            sv = S.step(m64p, State(q=q, v=v), tau)
            qk, vk = step64(fs.to_soa(q), fs.to_soa(v), fs.to_soa(tau))
            torch.cuda.synchronize()
            dq, dv = (sv.q - qk.T).abs().amax(1), (sv.v - vk.T).abs().amax(1)
            flips = max(flips, int(((dq > 1e-7) | (dv > 1e-5)).sum()))
            eq, ev = max(eq, dq.median().item()), max(ev, dv.median().item())
            q, v = qk.T.contiguous(), vk.T.contiguous()
    print(f"[vmap-step] f64 B={B}, 20 steps re-synced to the fused step kernel: at most {flips} envs "
          f"outside q 1e-7 / v 1e-5 in a step (active-set flips); median env |dq| <= {eq:.3e}, "
          f"|dv| <= {ev:.3e}")
    check(flips <= B // 100, "the vmap step disagrees with the fused step kernel on > 1% of envs")

    # ---- 14. vmap-main: rollout on the vmap stack through the sweep kernel ----
    m32p = m32.replace(contact_solver="lowrank_pallas")
    state_b = State(q=q_main, v=torch.zeros(B, m32.nv, device="cuda"))
    with torch.no_grad():
        reset_counts()
        final_v, _ = S.rollout(m32p, state_b, taus)
        torch.cuda.synchronize()
        launches_single = P.KERNEL_SINGLE.launches
    z = final_v.q[:, 0]
    finite_v = bool(torch.isfinite(final_v.q).all() and torch.isfinite(final_v.v).all())
    print(f"[vmap-main] rollout (vmap stack, lowrank_pallas) B={B} T={T} f32: {launches_single} "
          f"jacobi_sweeps_single launches; final torso z min {z.min().item():.4f} max "
          f"{z.max().item():.4f}; finite {finite_v}")
    check(launches_single == T, f"expected {T} sweep launches on the vmap path, got {launches_single}")
    check(finite_v and bool(((z > 0.0) & (z < 1.0)).all()), "bad final state on the vmap path")
    lcp32 = lcps[torch.float32]
    a32 = (lcp32.A, lcp32.b, lcp32.lo, lcp32.hi, lcp32.mu)
    it = m32.contact_iters
    Bs, Ds = lcp32.b.shape
    sweep_bound_ms, sw_tb, sw_to = sweep_bound(Bs, Ds, it, torch.float32)
    sweep64_bound_ms = sweep_bound(Bs, Ds, it, torch.float64)[0]
    with torch.no_grad():
        rd14 = sweep_readings(lib_sw, lcp32, lcps[torch.float64], it)
        sweep_ms, sweep_issue_ms = rd14["cold"], rd14["issue_cold"]
        sweep_wrap_ms = host_ms(lambda: P.jacobi_sweeps_pallas_single(*a32, lcp32.fidx, it), reps=200)
        sweep_plain_ms = cuda_ms(lambda: _jacobi(*a32, lcp32.fidx, it), reps=20)
        vstep_ms = cuda_ms(lambda: S.step(m32p, state_b, taus[0]), reps=5)
        vroll_ms = cuda_ms(lambda: S.rollout(m32p, state_b, taus), reps=2)
    sps_v = B * T / (vroll_ms * 1e-3)
    print(f"[vmap-main] sweep kernel on {card}, device ms per launch: "
          f"{sweep_line(rd14, sweep_bound_ms, sweep64_bound_ms)}")
    print(f"[vmap-main] timing on {card}: sweep kernel {sweep_ms:.4f} ms/launch on the device, cold "
          f"(issuing one launch {sweep_issue_ms:.4f} ms on the host; one wrapper call "
          f"{sweep_wrap_ms:.4f} ms on the host), plain _jacobi {sweep_plain_ms:.4f} ms; vmap step "
          f"{vstep_ms:.3f} ms; rollout {vroll_ms:.2f} ms = {sps_v:.6g} fwd env-steps/s (fused path: "
          f"{sps:.6g})")
    check(rd14["issue"] < rd14["warm"] and sweep_issue_ms < sweep_ms,
          "the sweep kernel's timing waited on the host")
    with torch.no_grad():
        vstep_host_ms = host_ms(lambda: S.step(m32p, state_b, taus[0]), reps=1)
    print(f"[vmap-main] host time to enqueue one vmap step {vstep_host_ms:.3f} ms of its "
          f"{vstep_ms:.3f} ms on the device clock")

    # ---- 15. batched: step_batched through the batched sweep kernel ----
    with torch.no_grad():
        reset_counts()
        sb = state_b
        for t in range(T):
            sb = step_batched(m32, sb, taus[t])
        torch.cuda.synchronize()
        launches_batched = P.KERNEL.launches
    zb = sb.q[:, 0]
    print(f"[batched] step_batched B={B} T={T} f32: {launches_batched} jacobi_sweeps launches; final "
          f"torso z min {zb.min().item():.4f} max {zb.max().item():.4f}; finite "
          f"{bool(torch.isfinite(sb.q).all())}")
    check(launches_batched == T, f"expected {T} batched sweep launches, got {launches_batched}")
    check(bool(torch.isfinite(sb.q).all() and torch.isfinite(sb.v).all()), "non-finite step_batched state")
    m64b = m64.replace(lcp_pivot_iters=0)
    q, v, tau = bs(q_np, torch.float64), bs(v_np, torch.float64), bs(tau_np, torch.float64)
    with torch.no_grad():
        sb64 = step_batched(m64b, State(q=q, v=v), tau)
        sv64 = S.step(m64b, State(q=q, v=v), tau)
    dq, dv = (sb64.q - sv64.q).abs().amax(1), (sb64.v - sv64.v).abs().amax(1)
    share_b = ((dq <= 1e-7) & (dv <= 1e-5)).double().mean().item()
    with torch.no_grad():
        batched_ms = cuda_ms(lambda: step_batched(m32, state_b, taus[0]), reps=5)
        rd15 = sweep_readings(lib_sw, lcp32, lcps[torch.float64], it)
        batched_sweep_ms, batched_issue_ms = rd15["cold"], rd15["issue_cold"]
        batched_wrap_ms = host_ms(lambda: P.jacobi_sweeps_pallas(*a32, lcp32.fidx, it), reps=200)
    print(f"[batched] f64 step vs the vmap step: {100 * share_b:.2f}% of envs within q 1e-7, v 1e-5 "
          f"(max |dq| {dq.max().item():.3e}, |dv| {dv.max().item():.3e}); timing on {card}: "
          f"step_batched {batched_ms:.3f} ms/step, sweep kernel {batched_sweep_ms:.4f} ms/launch on "
          f"the device, cold (issue {batched_issue_ms:.4f} ms, wrapper call {batched_wrap_ms:.4f} ms "
          f"on the host)")
    print(f"[batched] sweep kernel on {card}, device ms per launch: "
          f"{sweep_line(rd15, sweep_bound_ms, sweep64_bound_ms)}")
    check(rd15["issue"] < rd15["warm"] and batched_issue_ms < batched_sweep_ms,
          "the sweep kernel's timing waited on the host")
    check(share_b >= 0.99, "step_batched disagrees with the vmap step")

    # ---- 16. vmap-bptt: rollout_fast falls back to the vmap stack for mass gradients ----
    import warnings

    def vmap_bptt():
        mass = m32p.mass.clone().requires_grad_(True)
        taus_g = taus.clone().requires_grad_(True)
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            fin = rollout_fast(m32p.replace(mass=mass), state_b, taus_g)
        loss = (fin.q[:, 1] ** 2).mean() + 1e-4 * (taus_g**2).mean()
        loss.backward()
        return taus_g.grad, mass.grad, caught

    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    dtaus_v, dmass, caught = vmap_bptt()
    torch.cuda.synchronize()
    launches_bptt = P.KERNEL_SINGLE.launches
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    warned = [str(w.message) for w in caught if issubclass(w.category, UserWarning)]
    d_dyn_v = dtaus_v - g_reg
    share_v = (d_dyn_v != 0).any(-1).any(0).double().mean().item()
    print(f"[vmap-bptt] rollout_fast with mass requiring grad, B={B} T={T} f32: warned "
          f"{warned[:1]}; {launches_bptt} sweep launches (the forward solves; the backward "
          f"recomputes each step with its saved impulse), "
          f"{fs.KERNEL.launches} fused-step launches; dtau through the dynamics non-zero on "
          f"{100 * share_v:.2f}% of envs, max {d_dyn_v.abs().max().item():.3e}; d loss/d mass "
          f"{dmass.tolist()}; peak memory {peak_gb:.3f} GB")
    check(any("require grad" in w for w in warned), "rollout_fast did not warn about the fallback")
    check(fs.KERNEL.launches == 0, "the fused path ran where the vmap stack must")
    check(launches_bptt == T, f"expected {T} sweep launches in the vmap BPTT, got {launches_bptt}")
    check(bool(torch.isfinite(dtaus_v).all()) and share_v >= 0.99, "bad dtau on the vmap BPTT path")
    check(bool(torch.isfinite(dmass).all() and (dmass != 0).any()), "bad mass gradient")
    vbptt_ms = cuda_ms(vmap_bptt, reps=2)
    sps_vg = B * T / (vbptt_ms * 1e-3)
    print(f"[vmap-bptt] timing on {card}: loss + backward {vbptt_ms:.1f} ms = {sps_vg:.6g} fwd+grad "
          f"env-steps/s, peak memory {peak_gb:.3f} GB (fused path: {sps_grad:.6g}; the earlier "
          f"rollout, which re-ran every LCP solve in the backward pass with 2T sweep launches: "
          f"9587.7 ms on an NVIDIA H100 80GB HBM3 at 700.00 W)")

    # ---- 17. vmap-reference: float64 gradients through the kernel vs the plain sweeps ----
    Br, Tr = 256, 10
    m64r = m64.replace(contact_solver="lowrank")
    st_r = State(q=cheetah_init_q(m64).repeat(Br, 1), v=torch.zeros(Br, m64.nv, dtype=torch.float64,
                                                                    device="cuda"))
    taus_ref = taus[:Tr, :Br].double()
    conv = torch.ones(Br, dtype=torch.bool, device="cuda")
    with torch.no_grad():
        s_ = st_r
        for t in range(Tr):
            conv &= solver_diagnostics(m64r, s_, taus_ref[t]) < 1e-8
            s_ = S.step(m64r, s_, taus_ref[t])
    w = conv.double()

    def grads(model):
        mass = model.mass.clone().requires_grad_(True)
        x = taus_ref.clone().requires_grad_(True)
        fin = S.rollout_checkpointed(model.replace(mass=mass), st_r, x)
        return torch.autograd.grad((w * fin.q[:, 1] ** 2).sum() / w.sum(), (x, mass))

    gk = grads(m64r.replace(contact_solver="lowrank_pallas"))
    gp = grads(m64r)
    torch.cuda.synchronize()
    ok_r = True
    for name, a, b in zip(("dtau", "dmass"), gk, gp):
        tol = vc.VJP_RTOL * b.abs() + vc.VJP_ATOL * b.abs().max()
        within = ((a - b).abs() <= tol)
        ok_r &= bool(within[:, conv].all()) if name == "dtau" else bool(within.all())
        print(f"[vmap-reference] f64 B={Br} T={Tr}, {int(conv.sum())} converged envs: {name} max "
              f"|difference| {(a - b).abs().max().item():.3e} of max |{name}| {b.abs().max().item():.3e}")
    check(bool(gp[0].abs().max() > 0) and bool(gp[1].abs().max() > 0), "zero reference gradient")
    check(int(conv.sum()) >= Br // 2, "too few converged envs for the reference check")
    check(ok_r, "the float64 gradient through the sweep kernel disagrees with the plain sweeps")

    # ---- 18. jacobians: timestep Jacobians on the card ----
    from diffdart_tpu_torch.neural import LossGradient, backprop, timestep_jacobians

    # phase 14's rollout, started 0.15 lower (the standing start leaves the
    # feet in the air for its first 10 steps): 4 active contacts per env
    q_low = q_main.clone()
    q_low[:, 0] -= 0.15
    with torch.no_grad():
        s10 = S.rollout_final(m32p, State(q=q_low, v=state_b.v), taus[:10])
    reset_counts()
    jac = timestep_jacobians(m32p, s10, taus[10])
    torch.cuda.synchronize()
    jac_launches = P.KERNEL_SINGLE.launches
    fin_share = torch.stack([torch.isfinite(x).flatten(1).all(1) for x in jac]).all(0).double().mean().item()
    shapes = {k: tuple(x.shape) for k, x in jac._asdict().items()}
    jac_runs = sorted(cuda_ms(lambda: timestep_jacobians(m32p, s10, taus[10]), reps=1) for _ in range(5))
    jac_ms = jac_runs[2]
    print(f"[jacobians] timestep_jacobians, half-cheetah B={B} f32 lowrank_pallas, after 10 steps: "
          f"blocks {shapes}; finite on {100 * fin_share:.2f}% of envs; {jac_launches} sweep launch(es) "
          f"per call (one forward solve; the {m32.nv} + {2 * m32.nv} backward rows run none); timing on "
          f"{card}: median {jac_ms:.1f} ms (min {jac_runs[0]:.1f}, max {jac_runs[-1]:.1f}, 5 runs) = "
          f"{B / (jac_ms * 1e-3):.6g} env-Jacobian-sets/s")
    check(len(shapes) == 7 and shapes["mass_vel"] == (B, m32.nbody, m32.nv)
          and shapes["vel_vel"] == (B, m32.nv, m32.nv), "bad Jacobian shapes")
    check(fin_share >= 0.99, "non-finite Jacobians on > 1% of envs")
    check(jac_launches == 1, f"expected 1 sweep launch per Jacobian call, got {jac_launches}")

    Bj = 256
    s10_64 = State(q=s10.q[:Bj].double(), v=s10.v[:Bj].double())
    tau_j = taus[10, :Bj].double()
    m64j = m64.replace(contact_solver="lowrank_pallas")
    with torch.no_grad():
        conv_j = solver_diagnostics(m64j, s10_64, tau_j) < 1e-8
    jk = timestep_jacobians(m64j, s10_64, tau_j)
    jp = timestep_jacobians(m64j.replace(contact_solver="lowrank"), s10_64, tau_j)
    worst = 0.0
    ok_j = True
    for name, a, b in zip(jk._fields, jk, jp):
        a, b = a[conv_j], b[conv_j]
        tol = vc.VJP_RTOL * b.abs() + vc.VJP_ATOL * b.abs().max()
        ok_j &= bool(((a - b).abs() <= tol).all())
        worst = max(worst, ((a - b).abs() / b.abs().max().clamp_min(1e-30)).max().item())
    print(f"[jacobians] on {card}, f64 B={Bj}, {int(conv_j.sum())} converged envs: kernel vs plain "
          f"sweeps, max "
          f"|difference| / max |block| {worst:.3e} (limits rtol {vc.VJP_RTOL:g} + atol {vc.VJP_ATOL:g})")
    check(int(conv_j.sum()) >= 8, "too few converged envs for the Jacobian checks")
    check(ok_j, "Jacobians through the sweep kernel disagree with the plain sweeps")

    # central differences on 8 converged envs; at eps = 1e-6 the float64
    # solve's own rounding (~1e-9 in v', the Woodbury floor eps/cfm times
    # the impulses) over 2 eps reaches ~1e-3, so the gate is at eps = 1e-5
    # and the 1e-6 reading is printed beside it
    from diffdart_tpu_torch.dynamics import dynamics as DD

    idx = torch.nonzero(conv_j).flatten()[:8]
    q8, v8, t8 = s10_64.q[idx], s10_64.v[idx], tau_j[idx]
    one = torch.ones((), dtype=torch.float64, device="cuda")

    def fd_errors(eps):
        with torch.no_grad():
            base_q = S.step(m64j, State(q=q8, v=v8), t8).q

            def out(q_, v_, t_, model=m64j):
                s_ = S.step(model, State(q=q_, v=v_), t_)
                return DD.position_difference(model, base_q, s_.q), s_.v

            def central(f):
                (pp, vp), (pm, vm) = f(eps), f(-eps)
                return (pp - pm) / (2 * eps), (vp - vm) / (2 * eps)

            fd = {k: [] for k in jk._fields}
            for j in range(m64.nv):
                e = torch.zeros_like(v8)
                e[:, j] = 1.0
                for (kp, kv), f in (
                        (("pos_pos", "pos_vel"),
                         lambda h: out(DD.integrate_positions(m64j, q8, h * e, one), v8, t8)),
                        (("vel_pos", "vel_vel"), lambda h: out(q8, v8 + h * e, t8)),
                        (("force_pos", "force_vel"), lambda h: out(q8, v8, t8 + h * e))):
                    dp, dv = central(f)
                    fd[kp].append(dp)
                    fd[kv].append(dv)
            for i in range(m64.nbody):
                dm = torch.zeros_like(m64j.mass)
                dm[i] = 1.0
                fd["mass_vel"].append(
                    central(lambda h: out(q8, v8, t8, m64j.replace(mass=m64j.mass + h * dm)))[1])
        return {k: (getattr(jk, k)[idx] - torch.stack(c, dim=-2 if k == "mass_vel" else -1))
                .abs().max().item() for k, c in fd.items()}

    fd_err, fd_err6 = fd_errors(1e-5), fd_errors(1e-6)
    print(f"[jacobians] on {card}, f64, 8 converged envs against central differences: eps 1e-5, max "
          f"|difference| "
          + ", ".join(f"{k} {e:.3e}" for k, e in fd_err.items()) + " (atol 3e-4); eps 1e-6 (the solve's "
          f"rounding over 2 eps), max {max(fd_err6.values()):.3e}")
    check(max(fd_err.values()) <= 3e-4, "the Jacobians disagree with central differences")

    g_rng = np.random.RandomState(3)
    gq_j, gv_j = (torch.tensor(g_rng.randn(Bj, m64.nv), device="cuda") for _ in range(2))
    bp = backprop(m64j, s10_64, tau_j, LossGradient(gq_j, gv_j, torch.zeros_like(gq_j)))

    def jt(Jq, Jv):  # J^T g per env
        return (Jq.transpose(-1, -2) @ gq_j.unsqueeze(-1)
                + Jv.transpose(-1, -2) @ gv_j.unsqueeze(-1)).squeeze(-1)

    bp_err = 0.0
    for got, want in zip(bp, (jt(jk.pos_pos, jk.pos_vel), jt(jk.vel_pos, jk.vel_vel),
                              jt(jk.force_pos, jk.force_vel))):
        bp_err = max(bp_err, ((got - want).abs().max() / want.abs().max()).item())
    print(f"[jacobians] on {card}, f64 B={Bj}: backprop against J^T g from the Jacobians, max "
          f"|difference| / max "
          f"|J^T g| {bp_err:.3e} (limit {vc.VJP_ATOL:g}: both are the IFT backward at the same impulse, "
          f"summed in another order, which the Woodbury solve amplifies by about eps/cfm)")
    check(bp_err <= vc.VJP_ATOL, "backprop disagrees with J^T g")

    # ---- 19. dense-lcp: cube_drop through the dense boxed_lcp ----
    from diffdart_tpu_torch.models import cube_drop

    cube = cube_drop(dtype=torch.float32, device="cuda")
    half = 0.1
    q_c = cube.neutral_q().repeat(B, 1)
    gen = torch.Generator("cuda").manual_seed(0)
    q_c[:, 6] = half + 0.002 + 0.018 * torch.rand(B, device="cuda", generator=gen)
    dense_ms = {}
    for solver in ("pgs", "jacobi"):
        mc = cube.replace(contact_solver=solver)
        v0 = torch.zeros(B, cube.nv, device="cuda", requires_grad=True)
        zeros = torch.zeros(200, B, cube.nv, device="cuda")
        reset_counts()
        fin_c = S.rollout_checkpointed(mc, State(q=q_c, v=v0), zeros)
        (g_v0,) = torch.autograd.grad(fin_c.q[:, 4:].sum(), v0)
        torch.cuda.synchronize()
        launches_c = P.KERNEL.launches + P.KERNEL_SINGLE.launches
        z_c = fin_c.q[:, 6].detach()
        err_c = (z_c - half).abs().max().item()
        with torch.no_grad():
            dense_ms[solver] = cuda_ms(lambda: S.step(mc, State(q=q_c, v=v0.detach()), zeros[0]), reps=5)
        print(f"[dense-lcp] cube_drop B={B} f32 contact_solver={solver!r}, 200 steps from rest 2-20 mm up: "
              f"resting height max |z - {half}| {err_c:.3e} (limit 1e-3); d(final position)/d(v0) finite "
              f"{bool(torch.isfinite(g_v0).all())}, max {g_v0.abs().max().item():.3e}; {launches_c} sweep-"
              f"kernel launches; timing on {card}: {dense_ms[solver]:.3f} ms per step")
        check(err_c <= 1e-3, f"{solver}: the cube does not rest at its half-extent")
        check(bool(torch.isfinite(g_v0).all()) and bool((g_v0 != 0).any()), f"{solver}: bad gradient")
        check(launches_c == 0, f"{solver}: the dense solver launched the sweep kernel")

    # ---- 20. bilateral: ball and weld rows through the sweep kernel ----
    from diffdart_tpu_torch.dynamics.model import (
        JointType, ModelBuilder, add_ball_constraint, add_weld_constraint)
    from diffdart_tpu_torch.dynamics.kinematics import fk
    from diffdart_tpu_torch.math.lie import tf_apply
    from diffdart_tpu_torch.models import chain

    def free_bodies(n, **kw):
        b_ = ModelBuilder(dt=1e-3)
        for _ in range(n):
            b_.add_body(parent=-1, jtype=JointType.FREE, mass=1.0, inertia=np.eye(3) * 0.01, **kw)
        return b_.finalize(dtype=torch.float32, device="cuda")

    pend = add_ball_constraint(free_bodies(1, com=(0.3, 0, 0)), -1, 0, world_point=(0.0, 0.0, 0.0))
    pair = free_bodies(2)
    q_pair = pair.neutral_q()
    q_pair[11] = 0.4
    pair = add_weld_constraint(pair.replace(gravity=torch.zeros(3, device="cuda")), 0, 1, q=q_pair)
    rng_b = np.random.RandomState(4)
    for name, mb, q_b, v_b in (
            ("ball", pend, pend.neutral_q(), np.zeros(6)),
            ("weld", pair, q_pair, np.r_[1.5, 0, 0, 0, 0.5, 0, np.zeros(6)])):
        mb = mb.replace(contact_solver="lowrank_pallas")
        st = State(q=q_b.repeat(B, 1), v=bs(v_b + 0.1 * rng_b.randn(B, mb.nv), torch.float32))
        with torch.no_grad():
            lcp_b = prepare_constrained(mb, st)[0]
            reset_counts()
            fin_b = S.rollout_final(mb, st, torch.zeros(200, B, mb.nv, device="cuda"))
            torch.cuda.synchronize()
            launches_b = P.KERNEL_SINGLE.launches
        args = (lcp_b.A, lcp_b.b, lcp_b.lo, lcp_b.hi, lcp_b.mu)
        got = P.jacobi_sweeps_pallas_single(*args, lcp_b.fidx, mb.contact_iters)
        want = _jacobi(*args, lcp_b.fidx, mb.contact_iters)
        host = P.host_sweeps(*args, lcp_b.fidx, mb.contact_iters, dtype=torch.float32)
        torch.cuda.synchronize()
        err_b, rel_b = sc.sweep_error(got, want)
        exact_b = bool(torch.equal(got.cpu(), host))
        R_b, p_b = fk(mb, fin_b.q)
        limit_b = 2e-3 if name == "ball" else 5e-3  # tests/test_bilateral.py's bounds
        if name == "ball":
            gap = p_b[:, 0].norm(dim=-1).max().item()
        else:
            rel = R_b[:, 0].transpose(-1, -2) @ R_b[:, 1]
            gap = max((rel - mb.weld_rel_rot[0]).abs().max().item(),
                      ((p_b[:, 1] - p_b[:, 0]).norm(dim=-1) - 0.4).abs().max().item())
        print(f"[bilateral] on {card}, {name}, B={B} f32, D={lcp_b.b.shape[-1]} rows (lo -inf, hi +inf), "
              f"200 steps "
              f"with lowrank_pallas: {launches_b} sweep launches; "
              f"{'anchor gap' if name == 'ball' else 'relative pose error'} max {gap:.3e} (limit "
              f"{limit_b:g}); first step's lam: "
              f"kernel vs _jacobi max relative {rel_b:.3e} (limit {sc.REL_F32:g}), == host build bit for "
              f"bit {exact_b}")
        check(launches_b == 200, f"{name}: expected 200 sweep launches, got {launches_b}")
        check(gap <= limit_b, f"{name}: the constraint drifted")
        check(sc.sweep_ok(got, want), f"{name}: the sweep kernel disagrees with _jacobi on bilateral rows")
        check(exact_b, f"{name}: the sweep kernel differs from its host build on bilateral rows")
    five = [JointType.SCREW, JointType.UNIVERSAL, JointType.EULER, JointType.TRANSLATIONAL,
            JointType.TRANSLATIONAL2D]
    Bc = 256
    rng_c = np.random.RandomState(5)
    q_ch, v_ch = rng_c.randn(Bc, 11) * 0.3, rng_c.randn(Bc, 11) * 0.5
    outs_c = []
    for dev in ("cuda", "cpu"):
        mch = chain(n=5, jtypes=five, dtype=torch.float64, device=dev)
        st = State(q=torch.tensor(q_ch, device=dev), v=torch.tensor(v_ch, device=dev))
        with torch.no_grad():
            outs_c.append(S.rollout_final(mch, st, torch.zeros(100, Bc, mch.nv, dtype=torch.float64,
                                                                device=dev)))
    dq_c = (outs_c[0].q.cpu() - outs_c[1].q).abs().max().item()
    dv_c = (outs_c[0].v.cpu() - outs_c[1].v).abs().max().item()
    print(f"[bilateral] on {card}, chain of SCREW, UNIVERSAL, EULER, TRANSLATIONAL, TRANSLATIONAL2D, "
          f"B={Bc} f64, "
          f"100 steps, card vs CPU: max |dq| {dq_c:.3e}, |dv| {dv_c:.3e} (limit 1e-9)")
    check(dq_c <= 1e-9 and dv_c <= 1e-9, "the new joint types differ between the card and the CPU")

    # ---- 21-24. the Atlas-class humanoid ----
    hum = humanoid_phases(card, lib_sw, reset_counts)

    # ---- 25-28. convex and hybrid models, the pair budget, the dynamics API, trajectories ----
    s9 = slice9_phases(card, reset_counts)

    # ---- 29. convex-fused: the octahedron on kernels 1 and 2 ----
    cvx = convex_fused_phase(card, lib, reset_counts, s9["convex_vmap_ms"])

    # ---- 30. loaders-world: scene files, the World, goldens, IK, the pivot oracle ----
    s10 = loaders_world_phase(card, reset_counts)

    # ---- 31-34. data-parallel BPTT, utils, the viewer, the bridge ----
    dp = parallel_phase(card, reset_counts, kernel_ms, vjp_ms)
    utils_phase(card, dp, m32, state, taus)
    viewer_phase(card, m32, state, taus)
    launches_bridge = bridge_phase(card, reset_counts)

    # ---- kernel line ----
    m_cpu = half_cheetah(dt=2e-3, dtype=torch.float32, device="cpu")
    one = [x[:, :1].cpu() for x in (qs, vs, ts)]
    ops = ops_per_env_step(m_cpu, *one)
    di, df = fs.pack_descriptor(m32)
    nbytes = (2 * m32.nq + 3 * m32.nv) * 4 * B + di.nbytes + df.size * 4
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops * B / F32_OPS_PER_S
    bound_ms = 1e3 * max(t_bytes, t_ops)
    print(f"[bound] {ops} ops/env-step x {B} envs, {nbytes} bytes: bytes {1e3 * t_bytes:.3e} ms, "
          f"ops {1e3 * t_ops:.3e} ms")
    ops_v = ops_per_env_vjp(m_cpu, *one)
    nbytes_v = (3 * m32.nq + 5 * m32.nv) * 4 * B + di.nbytes + df.size * 4
    tv_bytes, tv_ops = nbytes_v / HBM_BYTES_PER_S, ops_v * B / F32_OPS_PER_S
    bound_vjp_ms = 1e3 * max(tv_bytes, tv_ops)
    print(f"[bound] VJP: {ops_v} ops/env-step x {B} envs, {nbytes_v} bytes: bytes "
          f"{1e3 * tv_bytes:.3e} ms, ops {1e3 * tv_ops:.3e} ms; the tape's own byte floor (this "
          f"design's, not the work's): {nodes32} nodes x {fs.tape_bytes(torch.float32, 1, 1)} bytes x "
          f"{B} envs, written once and read once, "
          f"{1e3 * 2 * fs.tape_bytes(torch.float32, nodes32, B) / HBM_BYTES_PER_S:.4f} ms")
    sw_ops = 2 * Ds * Ds + 5 * Ds + it * (2 * Ds * Ds + 20 * Ds)
    print(f"[bound] sweeps: {sw_ops} ops/env x {Bs} envs, {(Bs * Ds * Ds + 5 * Bs * Ds) * 4 + Ds * 8} "
          f"bytes (B={Bs}, D={Ds}, iters={it}): bytes {sw_tb:.3e} ms, ops {sw_to:.3e} ms")
    sweep_entries = [{
        "name": name,
        "design": "redesigned: one warp per env over its phase's rows, persistent warps; the "
                  "next env's A brought in by one bulk copy (TMA) while the warp sweeps the "
                  "current one; in float32 each lane holds its rows in registers (was one block "
                  "per env)",
        "route": "cuda",
        "source": "diffdart_tpu_torch/ops/csrc/jacobi_sweeps.cu",
        "replaces": replaces,
        "launches": launches_,
        **extra,
        "max_abs_err": sweep_errs[torch.float32, B],
        "ms": rd["cold"],
        "warm_ms": rd["warm"],
        "plain_ms": sweep_plain_ms,
        "bound_ms": sweep_bound_ms,
        "bound_by": "operations" if sw_to >= sw_tb else "bytes",
        "library_ms": None,
    } for name, replaces, launches_, rd, extra in (
        ("jacobi_sweeps", "diffdart_tpu/ops/pallas_lcp.py:26", launches_batched, rd15,
         {"launches_humanoid_step_batched": hum["launches_step_batched"],
          "launches_convex_step_batched": s9["launches_convex_step_batched"],
          "launches_pair_budget_step_batched": s9["launches_pair_budget_step_batched"]}),
        ("jacobi_sweeps_single", "diffdart_tpu/ops/pallas_lcp.py:124", launches_single, rd14,
         {"launches_fallback_bptt": launches_bptt, "launches_per_jacobian_set": jac_launches,
          "humanoid": {k: hum[k] for k in (
              "launches_rollout", "launches_bptt", "launches_jacobians", "launches_catapult",
              "shapes")},
          "slice9": {k: s9[k] for k in (
              "launches_convex_rollout", "launches_hybrid_fallback", "launches_pair_budget",
              "launches_catapult_iter", "launches_jumpworm_ilqr", "shapes")},
          "launches_native_oracle": s10["launches_native_oracle"],
          "launches_bridge": launches_bridge}))]
    parallel = {"model": f"half-cheetah, B = {DP_B} (2 x {DP_B // 2} in two processes), T = {DP_T}",
                "launches_per_process": {k: dp[f"launches_{k}"] for k in (
                    "one_process", "nccl_one_rank", "gloo_two_process")},
                "dp_step_ms": dp["dp_ms"], "bare_bptt_ms": dp["bare_ms"],
                "all_reduce_ms": dp["all_reduce_ms"]}
    print(json.dumps({"kernels": [{
        "name": "fused_step",
        "design": "redesigned: one warp per env, the LCP in shared memory, its solve split across "
                  "the lanes (was one thread per env)",
        "route": "cuda",
        "source": "diffdart_tpu_torch/ops/csrc/fused_step.cu",
        "replaces": "diffdart_tpu/ops/pallas_step.py:55",
        "launches": launches,
        "max_abs_err": f32_err,
        "ms": kernel_ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": "operations" if t_ops >= t_bytes else "bytes",
        "library_ms": None,
        "convex": {"model": "octahedron, 4 hull slots, D = 12, B = 4096",
                   **{k: cvx[k] for k in ("launches", "max_abs_err", "ms", "plain_ms", "bound_ms",
                                          "bound_by", "rollout_ms")}},
        "parallel": {**parallel, "device_ms_share": dp["device_share_step"]},
    }, {
        "name": "fused_step_vjp",
        "route": "cuda",
        "source": "diffdart_tpu_torch/ops/csrc/fused_step.cu",
        "replaces": "diffdart_tpu/ops/pallas_step.py:60",
        "launches": launches_vjp,
        "max_abs_err": vjp32_err,
        "ms": vjp_ms,
        "plain_ms": plain_vjp_ms,
        "bound_ms": bound_vjp_ms,
        "bound_by": "operations" if tv_ops >= tv_bytes else "bytes",
        "library_ms": None,
        "convex": {"model": "octahedron, 4 hull slots, D = 12, B = 4096", "launches": cvx["launches_vjp"],
                   "max_abs_err_f64": cvx["vjp_max_abs_err_f64"], "ms": cvx["vjp_ms"],
                   "plain_ms": cvx["plain_vjp_ms"], "bound_ms": cvx["bound_vjp_ms"],
                   "bound_by": cvx["bound_vjp_by"], "tape_nodes": cvx["tape_nodes"],
                   "bptt_ms": cvx["bptt_ms"]},
        "parallel": {**parallel, "launches_per_process": dp["launches_vjp"],
                     "device_ms_share": dp["device_share_vjp"]},
    }, *sweep_entries]}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
