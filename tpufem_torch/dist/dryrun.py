"""The multi-device dry run of the port: ``dryrun_multichip(n_shards)``,
the counterpart of the JAX package's ``__graft_entry__.dryrun_multichip``.

It runs the reference's six stages at their sizes and with their asserts,
from the port's modules, on a mesh of ``n_shards`` shards (on the card
unless ``device="cpu"``):

  1. 2D P1 Poisson (n = 4 x shards per side, fp32): assembly, Dirichlet
     elimination, identity-row padding, the sharded halo CG to 1e-5;
  2. 3D distributed MG (n = 16, fp64): a manufactured solution to 1e-9,
     error below 1e-6;
  3. general geometry (n = 14, perturbed interior, fp32): the sharded
     fused build (kernel B8, one launch per shard) feeding the sharded
     halo CG to 1e-5;
  4. distributed AMG (48 x 48 perturbed mesh, fp32): RCM, the sharded
     interval hierarchy (``coarse_n=120``) and its W-cycle PCG to 1e-8
     within 100 iterations;
  5. 2D elasticity (12 x 12, fp32): BCSR assembly and the node-stripe
     block-Jacobi CG to 1e-9;
  6. 20 leapfrog steps of stage 1's operator, fp32 energy drift below
     1e-5.

Stage 1's element batch is assembled on the mesh's
first device (the reference shards it and lets XLA insert the assembly's
collectives).  Returns each stage's numbers.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["dryrun_multichip"]


def dryrun_multichip(n_shards: int, device=None) -> dict:
    """Run the multi-device stages on a mesh of ``n_shards`` shards."""
    from tpufem_torch.assemble.dense import assemble_vector
    from tpufem_torch.assemble.local import element_load, p1_stiffness
    from tpufem_torch.assemble.stencil import stencil_values
    from tpufem_torch.dist.cg import stencil_cg_sharded
    from tpufem_torch.dist.mesh import make_mesh, unshard
    from tpufem_torch.dist.partition import pad_rows
    from tpufem_torch.fem.elements import P1Triangle
    from tpufem_torch.fem.quadrature import triangle_rule
    from tpufem_torch.mesh.adjacency import ell_pattern
    from tpufem_torch.mesh.rectangle import rectangle_mesh
    from tpufem_torch.solve.bc import apply_dirichlet_stencil
    from tpufem_torch.solve.poisson import model_problem_2d
    from tpufem_torch.sparse.stencil import StencilMatrix, stencil_pattern

    out = {}
    dmesh = make_mesh(n_shards, ("rows",), device=device)
    home = dmesh.home

    # tiny but halo-safe: rows/shard must exceed the stencil halo
    n = 4 * n_shards
    mesh = rectangle_mesh(-3.0, 3.0, -3.0, 3.0, n, n)
    pattern = stencil_pattern(mesh.conn, mesh.num_nodes)
    element = P1Triangle()
    rule = triangle_rule(5)
    f, _ = model_problem_2d()
    bc_mask = torch.as_tensor(mesh.node_flags != 0, device=home)
    num_nodes = mesh.num_nodes
    offsets = tuple(int(o) for o in pattern.offsets)
    diag_k = offsets.index(0)

    ec = torch.as_tensor(mesh.element_coords(), dtype=torch.float32,
                         device=home)
    Ke = p1_stiffness(ec, element)
    data = stencil_values(pattern, Ke)
    b = assemble_vector(mesh.conn, element_load(ec, element, rule, f),
                        num_nodes)
    A, b = apply_dirichlet_stencil(StencilMatrix(data, offsets), b, bc_mask)
    data_p, b_p, n_orig = pad_rows(A.data, b, offsets, n_shards, diag_k)

    res = stencil_cg_sharded(data_p, offsets, b_p, dmesh, tol=1e-5,
                             maxiter=200)
    x = unshard(res.x)[:n_orig]
    assert bool(torch.isfinite(x).all()), \
        "multichip dry run produced non-finite x"
    assert res.converged or res.iterations == 200
    out["stencil_cg"] = dict(dofs=num_nodes, iterations=res.iterations,
                             relres=float(res.residual_norm),
                             converged=res.converged)
    print(f"dryrun_multichip({n_shards}): {num_nodes} dofs, "
          f"cg iters={res.iterations}, relres={float(res.residual_norm):.2e}, "
          f"converged={res.converged}")

    # ---- 3D distributed multigrid: z-plane-sharded V-cycle + halo CG ----
    from tpufem_torch.dist.multigrid import (build_dist_hierarchy,
                                             grid_stencil_matvec,
                                             solve_poisson_dist)

    dmesh3 = make_mesh(n_shards, ("z",), device=device)
    n3 = 16
    levels = build_dist_hierarchy((-3.0, 3.0), n3, 3, n_shards,
                                  dtype=np.float64)
    fine = levels[0]
    ng = fine.node_grid
    rng = np.random.default_rng(0)
    xt = np.where(fine.bc_mask[:ng[0]], 0.0, rng.standard_normal(ng))
    xt_p = np.pad(xt, [(0, fine.data.shape[1] - ng[0]), (0, 0), (0, 0)])
    b3 = grid_stencil_matvec(torch.as_tensor(fine.data), torch.as_tensor(xt_p),
                             fine.offsets_grid, None).numpy()[:ng[0]]
    u, res3 = solve_poisson_dist((-3.0, 3.0), n3, 3, dmesh3, b3.reshape(-1),
                                 dtype=np.float64, tol=1e-9, maxiter=60)
    err = np.linalg.norm(u - xt.reshape(-1)) / np.linalg.norm(xt)
    assert res3.converged, float(res3.residual_norm)
    # err <= cond(A) * relres; 1e-6 leaves headroom for the ~1e2 condition
    assert err < 1e-6, err
    out["dist_mg"] = dict(dofs=int(np.prod(ng)), iterations=res3.iterations,
                          relres=float(res3.residual_norm), err=float(err))
    print(f"dryrun_multichip 3D dist-MG: {int(np.prod(ng))} dofs, "
          f"mgpcg iters={res3.iterations}, "
          f"relres={float(res3.residual_norm):.2e}, err={err:.2e}")

    # ---- general geometry: sharded fused assembly -> sharded halo CG ----
    from tpufem_torch.assemble.structured import structured_plan
    from tpufem_torch.dist.assembly import solve_poisson_dist_general
    from tpufem_torch.fem.quadrature import tetrahedron_rule
    from tpufem_torch.ops.fused_system_cuda import \
        node_coords_embedded_from_grid
    from tpufem_torch.solve.multigrid import _light_grid
    from tpufem_torch.solve.poisson import model_problem_3d_planes

    ng4 = 14                      # store z = 24 -> 3 planes per shard at 8
    info4, coords_grid4, bc4 = _light_grid((-3.0, 3.0), ng4, 3)
    plan4 = structured_plan(info4, embed=True)
    h4 = 6.0 / ng4
    pert = rng.uniform(-0.1 * h4, 0.1 * h4, size=coords_grid4.shape)
    interior = ~np.broadcast_to(bc4, coords_grid4.shape)
    C4 = torch.as_tensor(node_coords_embedded_from_grid(
        coords_grid4 + np.where(interior, pert, 0.0), plan4, np.float32))
    u4, res4 = solve_poisson_dist_general(
        plan4, C4, dmesh3, model_problem_3d_planes(), tetrahedron_rule(2),
        tol=1e-5, maxiter=2000)
    assert res4.converged, float(res4.residual_norm)
    assert np.isfinite(u4).all()
    out["dist_assembly"] = dict(dofs=int(np.prod(info4.node_grid)),
                                iterations=res4.iterations,
                                relres=float(res4.residual_norm))
    print(f"dryrun_multichip sharded-assembly pipeline: "
          f"{int(np.prod(info4.node_grid))} dofs (perturbed geometry), "
          f"cg iters={res4.iterations}, "
          f"relres={float(res4.residual_norm):.2e}")

    # ---- distributed unstructured AMG: perturbed mesh -> RCM -> sharded
    # interval hierarchy -> W-cycle PCG (transfers shard-local by the
    # stripe-height invariant, matvecs halo-exchange)
    from tpufem_torch.assemble.ell import assemble_ell
    from tpufem_torch.dist.amg import build_dist_amg, dist_amg_pcg
    from tpufem_torch.mesh.adjacency import reverse_cuthill_mckee
    from tpufem_torch.mesh.core import Mesh as FemMesh
    from tpufem_torch.mesh.rectangle import perturbed_rectangle_mesh
    from tpufem_torch.solve.bc import apply_dirichlet_ell

    n5 = 48
    mesh5 = perturbed_rectangle_mesh(-3.0, 3.0, -3.0, 3.0, n5, n5,
                                     jitter=0.25, seed=0)
    pat5 = ell_pattern(mesh5.conn, mesh5.num_nodes, pad_to=8)
    perm5 = reverse_cuthill_mckee(pat5.cols)
    inv5 = np.empty_like(perm5)
    inv5[perm5] = np.arange(perm5.size, dtype=perm5.dtype)
    mesh5 = FemMesh(coords=np.ascontiguousarray(mesh5.coords[perm5]),
                    conn=inv5[mesh5.conn].astype(mesh5.conn.dtype),
                    node_flags=np.ascontiguousarray(mesh5.node_flags[perm5]),
                    cell_type=mesh5.cell_type)
    pat5 = ell_pattern(mesh5.conn, mesh5.num_nodes, pad_to=8)
    ec5 = torch.as_tensor(mesh5.element_coords(), dtype=torch.float32,
                          device=home)
    A5 = assemble_ell(pat5, p1_stiffness(ec5, element))
    b5 = assemble_vector(mesh5.conn, element_load(ec5, element, rule, f),
                         mesh5.num_nodes)
    A5, b5 = apply_dirichlet_ell(
        A5, b5, torch.as_tensor(mesh5.node_flags != 0, device=home))
    h5 = build_dist_amg(A5.data, A5.cols, n_shards, coarse_n=120)
    x5, res5 = dist_amg_pcg(h5, b5, dmesh, tol=1e-8, maxiter=100)
    assert res5.converged, float(res5.residual_norm)
    assert bool(torch.isfinite(x5).all())
    out["dist_amg"] = dict(dofs=mesh5.num_nodes,
                           levels=len(h5.level_arrays),
                           iterations=res5.iterations,
                           relres=float(res5.residual_norm))
    print(f"dryrun_multichip dist-AMG: {mesh5.num_nodes} dofs "
          f"(perturbed unstructured, RCM, {len(h5.level_arrays)} levels), "
          f"W-cycle PCG iters={res5.iterations}, "
          f"relres={float(res5.residual_norm):.2e}")

    # ---- distributed vector-block (BCSR) elasticity: node-stripe halo CG
    from tpufem_torch.dist.ell import distributed_bcsr_solve
    from tpufem_torch.fem.space import VectorFunctionSpace
    from tpufem_torch.solve.elasticity import elasticity_forms
    from tpufem_torch.sparse.bcsr import apply_dirichlet_bcsr, assemble_bcsr

    mesh6 = rectangle_mesh(0.0, 1.0, 0.0, 1.0, 12, 12)
    V6 = VectorFunctionSpace(mesh6, degree=1)
    wf6 = elasticity_forms(
        V6, 1.2, 0.7,
        lambda x: torch.stack([torch.sin(x[..., 0]), x[..., 1] ** 2],
                              dim=-1))
    wf6.dtype = torch.float32
    ec6 = torch.as_tensor(mesh6.element_coords(), device=home)
    pat6 = ell_pattern(V6.scalar_dof_conn, V6.num_scalar_dofs, pad_to=8)
    A6 = assemble_bcsr(pat6, wf6.element_matrices(ec6), block_size=2)
    b6 = assemble_vector(V6.dof_conn, wf6.element_vectors(ec6), V6.num_dofs)
    A6, b6 = apply_dirichlet_bcsr(A6, b6, V6.dof_flags)
    x6, res6 = distributed_bcsr_solve(A6, b6, dmesh, tol=1e-9, maxiter=2000)
    assert res6.converged, float(res6.residual_norm)
    assert bool(torch.isfinite(x6).all())
    out["dist_bcsr"] = dict(dofs=V6.num_dofs, iterations=res6.iterations,
                            relres=float(res6.residual_norm))
    print(f"dryrun_multichip dist-BCSR elasticity: {V6.num_dofs} dofs "
          f"(2x2 node blocks), halo CG iters={res6.iterations}, "
          f"relres={float(res6.residual_norm):.2e}")

    # ---- distributed transient dynamics: sharded leapfrog, reusing stage
    # 1's assembled + Dirichlet-projected stencil system
    from tpufem_torch.dist.dynamics import leapfrog_wave_sharded

    npad7 = b_p.shape[0]
    c7 = torch.as_tensor(mesh.coords, device=home)
    u07 = (torch.sin(torch.pi * (c7[:, 0] + 3) / 6)
           * torch.sin(torch.pi * (c7[:, 1] + 3) / 6)).to(torch.float32)
    u07 = torch.where(bc_mask, 0.0, u07)
    u07 = torch.nn.functional.pad(u07, (0, npad7 - num_nodes))
    mL7 = torch.ones(npad7, dtype=torch.float32, device=home)
    bc7 = torch.cat([bc_mask, torch.ones(npad7 - num_nodes, dtype=torch.bool,
                                         device=home)])
    res7 = leapfrog_wave_sharded(data_p, offsets, mL7, u07,
                                 torch.zeros_like(mL7), 1e-3, 20, dmesh,
                                 bc_mask=bc7)
    e7 = res7.energy.double().cpu().numpy()
    drift7 = float(np.abs(e7 - e7[0]).max() / abs(e7[0]))
    assert bool(torch.isfinite(unshard(res7.u)).all())
    assert drift7 < 1e-5, drift7          # fp32 floor; fp64 pins 1e-12
    out["dist_dynamics"] = dict(dofs=num_nodes, steps=20, drift=drift7)
    print(f"dryrun_multichip dist-dynamics: {num_nodes} dofs, 20 leapfrog "
          f"steps, energy drift={drift7:.2e}")
    return out
