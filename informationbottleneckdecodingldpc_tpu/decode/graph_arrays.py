"""Device-resident decode layout: degree-grouped, slot-major edge ordering.

The reference's OpenCL decoders walk per-node inbox pointers inside each work
item (kernels_template.cl). This layout instead pre-sorts edges so that

- all edges of same-degree nodes are contiguous, organized **slot-major**:
  a degree-d group's block holds d planes of ``num_nodes`` rows; plane j is
  "message j of every node" -> each node-update step is elementwise across
  whole planes (static slices, no gather);
- moving messages between the CN view and the VN view is one global
  permutation. For structured codes (quasi-cyclic 802.11n, q-group DVB-S2
  IRA) the slot-major ordering makes that permutation a concatenation of a
  few hundred long contiguous **runs**, executed as static slice copies;
  unstructured codes fall back to a row gather.

All index arrays are built in numpy from :class:`TannerGraph` once.
"""

from __future__ import annotations

import dataclasses

import jax.numpy as jnp
import numpy as np

from ..codes.graph import TannerGraph


@dataclasses.dataclass(frozen=True)
class GroupSpec:
    """A contiguous block of the decode edge layout for one node degree.

    Block rows [offset, offset + degree*num_nodes) hold plane j at
    [offset + j*num_nodes, offset + (j+1)*num_nodes): the j-th message slot
    of every node in the group.
    """

    degree: int
    offset: int
    num_nodes: int
    node_ids: jnp.ndarray  # [num_nodes] int32 original node indices


@dataclasses.dataclass(frozen=True)
class PermutationPlan:
    """dst[i] = src[perm[i]] decomposed into structured data moves.

    Decomposition (built once in numpy):

    1. maximal constant-stride runs: ``dst[s:s+l] = src[t : t+l*d : d]``;
    2. consecutive stride-``d`` runs of equal length whose sources advance by
       one coalesce into a **block transpose**: ``dst`` block =
       ``src[t:t+l*d].reshape(l, d).T`` — the class-major <-> natural node
       moves of q-group (DVB-S2 IRA) codes are exactly this shape, and XLA
       lowers one [l, d] transpose better than l strided slices.

    Whether this beats the single row gather (``perm``) on a given device is
    measured, not assumed (scripts/micro_bench.py).
    """

    perm: jnp.ndarray  # [n] int32 (fallback row gather)
    run_dst: np.ndarray  # [k] int64 start in dst
    run_src: np.ndarray  # [k] int64 start in src
    run_len: np.ndarray  # [k] int64
    run_stride: np.ndarray  # [k] int64 (stride in src; may be negative)
    # Transpose blocks, rows (dst, src, l, s, g, trim): dst[dst:dst+trim] =
    # src-rectangle [l, s] starting at src, first g columns, transposed,
    # raveled, truncated to trim elements.
    tr_ops: np.ndarray  # [m, 6] int64
    use_runs: bool

    @classmethod
    def from_permutation(cls, perm: np.ndarray, max_runs_fraction: float = 0.25):
        perm = np.asarray(perm, dtype=np.int64)
        n = perm.size
        if n == 0:
            e = np.zeros(0, dtype=np.int64)
            return cls(
                jnp.asarray(perm.astype(np.int32)),
                e, e, e, e, np.zeros((0, 6), dtype=np.int64), True,
            )

        # --- maximal constant-stride runs (greedy over link-change points;
        # link i is perm[i+1]-perm[i], a run consumes equal consecutive links)
        d = np.diff(perm)
        bnd = (
            np.nonzero(d[1:] != d[:-1])[0] if n > 2 else np.zeros(0, np.int64)
        )
        starts_l, lengths_l, strides_l = [], [], []
        s = 0
        bi = 0
        nb = bnd.size
        while s < n:
            if s == n - 1:
                starts_l.append(s)
                lengths_l.append(1)
                strides_l.append(1)
                break
            while bi < nb and bnd[bi] < s:
                bi += 1
            last_link = int(bnd[bi]) if bi < nb else n - 2
            starts_l.append(s)
            lengths_l.append(last_link - s + 2)  # elements s .. last_link+1
            strides_l.append(int(d[s]))
            s = last_link + 2
        starts = np.asarray(starts_l, dtype=np.int64)
        lengths = np.asarray(lengths_l, dtype=np.int64)
        strides = np.asarray(strides_l, dtype=np.int64)
        srcs = perm[starts]
        dsts = starts

        # Rebalance: the greedy scan steals the first element of a strided
        # block into a preceding run when the boundary link happens to match
        # the preceding stride (e.g. a contiguous prefix flowing into a
        # class-major transpose). Give it back when that equalizes the run
        # with its successor, so transpose coalescing can see a full block.
        for i2 in range(1, len(starts) - 1):
            if (
                strides[i2] > 1
                and lengths[i2] + 1 == lengths[i2 + 1]
                and strides[i2 + 1] == strides[i2]
                and lengths[i2 - 1] > 1
                and srcs[i2] - strides[i2]
                == srcs[i2 - 1] + (lengths[i2 - 1] - 1) * strides[i2 - 1]
            ):
                lengths[i2 - 1] -= 1
                srcs[i2] -= strides[i2]
                dsts[i2] -= 1
                lengths[i2] += 1

        # --- coalesce groups of stride-s runs into block transposes.
        # A group of g <= s consecutive runs (stride s, length l, sources
        # advancing by 1, destinations contiguous; the last run may be
        # shorter) is the first g columns of the transpose of the [l, s]
        # source rectangle, truncated to `trim` elements.
        run_keep = []
        trs = []
        k = len(starts)
        i = 0
        while i < k:
            s = int(strides[i])
            l = int(lengths[i])
            if s > 1 and l > 1:
                j = i
                while (
                    j + 1 < k
                    and j + 1 - i < s
                    and srcs[j + 1] == srcs[j] + 1
                    and dsts[j + 1] == dsts[j] + lengths[j]
                    and (
                        (strides[j + 1] == s and lengths[j + 1] <= l)
                        or lengths[j + 1] == 1
                    )
                ):
                    j += 1
                    if lengths[j] < l:
                        break  # truncated run ends the group
                g = j - i + 1
                if g >= 2:
                    trim = (g - 1) * l + int(lengths[j])
                    trs.append((dsts[i], srcs[i], l, s, g, trim))
                    i = j + 1
                    continue
            run_keep.append(i)
            i += 1

        # Leftover short non-unit-stride runs (stray boundary links the greedy
        # merged, not absorbed into a transpose) are no better than singletons:
        # split them back up.
        MIN_STRIDED_LEN = 4
        f_dst, f_src, f_len, f_stride = [], [], [], []
        for idx in run_keep:
            s0, t0, l0, st0 = dsts[idx], srcs[idx], lengths[idx], strides[idx]
            if st0 != 1 and l0 < MIN_STRIDED_LEN:
                for e in range(int(l0)):
                    f_dst.append(s0 + e)
                    f_src.append(t0 + e * st0)
                    f_len.append(1)
                    f_stride.append(1)
            else:
                f_dst.append(s0)
                f_src.append(t0)
                f_len.append(l0)
                f_stride.append(st0)

        tr = np.asarray(trs, dtype=np.int64).reshape(-1, 6)
        n_ops = len(f_dst) + tr.shape[0]
        use_runs = n_ops <= max(128, int(max_runs_fraction * n))
        return cls(
            perm=jnp.asarray(perm.astype(np.int32)),
            run_dst=np.asarray(f_dst, dtype=np.int64),
            run_src=np.asarray(f_src, dtype=np.int64),
            run_len=np.asarray(f_len, dtype=np.int64),
            run_stride=np.asarray(f_stride, dtype=np.int64),
            tr_ops=tr,
            use_runs=bool(use_runs),
        )

    @property
    def num_runs(self) -> int:
        return int(self.run_dst.size)

    @property
    def num_transposes(self) -> int:
        return int(self.tr_ops.shape[0])

    def apply(self, x: jnp.ndarray) -> jnp.ndarray:
        """Return x[perm] along axis 0."""
        if not self.use_runs:
            return jnp.take(x, self.perm, axis=0)
        # Emit pieces in dst order (runs and transposes are disjoint,
        # dst-sorted by construction).
        ops = [
            (int(d), "r", (int(t), int(l), int(st)))
            for d, t, l, st in zip(
                self.run_dst, self.run_src, self.run_len, self.run_stride
            )
        ] + [(int(row[0]), "t", tuple(int(v) for v in row[1:])) for row in self.tr_ops]
        ops.sort()
        pieces = []
        tail = x.shape[1:]
        for _, kind, op in ops:
            if kind == "r":
                t, l, st = op
                if st == 1:
                    pieces.append(x[t : t + l])
                elif st > 1:
                    pieces.append(x[t : t + (l - 1) * st + 1 : st])
                else:
                    stop = t + (l - 1) * st - 1
                    pieces.append(x[t : (stop if stop >= 0 else None) : st])
            else:
                t, l, s, g, trim = op
                # Last element actually consumed: full columns reach row l-1,
                # the (possibly truncated) final column reaches row l'-1.
                l_last = trim - (g - 1) * l
                span = max(
                    ((l - 1) * s + g - 1) if g > 1 else 0,
                    (l_last - 1) * s + g,
                )
                blk = x[t : t + span]
                pad = l * s - span
                if pad:
                    blk = jnp.pad(blk, ((0, pad),) + ((0, 0),) * len(tail))
                blk = blk.reshape((l, s) + tail)[:, :g]
                blk = jnp.moveaxis(blk, 0, 1).reshape((l * g,) + tail)
                pieces.append(blk[:trim])
        return jnp.concatenate(pieces, axis=0) if len(pieces) > 1 else pieces[0]


@dataclasses.dataclass(frozen=True)
class DecodeLayout:
    n_vars: int
    n_checks: int
    n_edges: int
    d_c_max: int
    d_v_max: int
    data_len: int
    code_rate: float

    cn_groups: tuple[GroupSpec, ...]
    vn_groups: tuple[GroupSpec, ...]

    # Layout moves (gather-free when run-structured):
    #   vn_view = to_vn.apply(cn_view); cn_view = to_cn.apply(vn_view)
    to_vn: PermutationPlan
    to_cn: PermutationPlan

    # Channel-value gather: variable node of each CN-layout edge (seeds the
    # check-node inboxes with channel values, kernels_template.cl:13-30).
    cn_edge_var: jnp.ndarray  # [n_edges] int32
    # Inverse node permutation to assemble outputs in natural variable order.
    vn_node_unperm: jnp.ndarray  # [n_vars] int32

    # Run-decomposed row-move plans (for structured codes a few hundred
    # slice copies instead of a row gather):
    #   seed_plan:       ch[n_vars] -> cn_view[n_edges] channel seeding
    #   vn_gather_plan:  ch[n_vars] -> per-VN-group node values (group order)
    #   vn_unperm_plan:  group-order node outputs -> natural variable order
    seed_plan: PermutationPlan
    vn_gather_plan: PermutationPlan
    vn_unperm_plan: PermutationPlan

    @classmethod
    def from_graph(
        cls,
        g: TannerGraph,
        cn_node_key: np.ndarray | None = None,
        vn_node_key: np.ndarray | None = None,
        cn_edge_key: np.ndarray | None = None,
        vn_edge_key: np.ndarray | None = None,
    ) -> "DecodeLayout":
        """Build the decode layout.

        ``cn_node_key`` / ``vn_node_key`` optionally reorder nodes *within*
        each degree group (ascending key). ``cn_edge_key`` (indexed by
        CSR edge position) / ``vn_edge_key`` (CSC edge position) optionally
        reorder each node's inbox *slots*: structured codes supply keys that
        give every node in a class the same slot-to-neighbor-block assignment
        (e.g. by parity-accumulator address for DVB-S2), which is what makes
        the CN<->VN permutation decompose into long runs / block transposes
        (codes/dvbs2.dvbs2_layout_edge_keys). Message-passing semantics don't
        depend on inbox order; outputs are always returned in natural
        variable order regardless.
        """
        # Decode layouts: per degree group, slot-major planes, nodes ordered
        # by the optional key, slots ordered by the optional edge key.
        def reorder(groups, key, edge_key):
            out = []
            for grp in groups:
                g2 = grp
                if edge_key is not None:
                    ek = np.asarray(edge_key)
                    order = np.argsort(ek[g2.edge_slots], axis=1, kind="stable")
                    g2 = dataclasses.replace(
                        g2,
                        edge_slots=np.take_along_axis(g2.edge_slots, order, axis=1),
                    )
                if key is not None:
                    k = np.asarray(key)
                    order = np.argsort(k[g2.node_ids], kind="stable")
                    g2 = dataclasses.replace(
                        g2,
                        node_ids=g2.node_ids[order],
                        edge_slots=g2.edge_slots[order],
                    )
                out.append(g2)
            return tuple(out)

        cn_groups_g = reorder(g.cn_groups, cn_node_key, cn_edge_key)
        vn_groups_g = reorder(g.vn_groups, vn_node_key, vn_edge_key)

        def slots_slot_major(groups):
            return np.concatenate(
                [grp.edge_slots.T.ravel() for grp in groups]  # [d, n] planes
            )

        cn_slots = slots_slot_major(cn_groups_g)
        vn_slots = slots_slot_major(vn_groups_g)
        cn_pos = np.empty(g.n_edges, dtype=np.int64)
        cn_pos[cn_slots] = np.arange(g.n_edges)
        vn_pos = np.empty(g.n_edges, dtype=np.int64)
        vn_pos[vn_slots] = np.arange(g.n_edges)

        # vn_view[i] = cn_view[cn_pos_of_vn_edge[i]] and vice versa.
        cn_pos_of_vn_edge = cn_pos[g.cn_slot_of_vn_edge[vn_slots]]
        vn_pos_of_cn_edge = vn_pos[g.vn_slot_of_cn_edge[cn_slots]]

        def specs(groups) -> tuple[GroupSpec, ...]:
            out, off = [], 0
            for grp in groups:
                out.append(
                    GroupSpec(
                        degree=grp.degree,
                        offset=off,
                        num_nodes=int(grp.node_ids.size),
                        node_ids=jnp.asarray(grp.node_ids),
                    )
                )
                off += grp.node_ids.size * grp.degree
            return tuple(out)

        node_order = np.concatenate([np.asarray(grp.node_ids) for grp in vn_groups_g])
        vn_node_unperm = np.empty(g.n_vars, dtype=np.int32)
        vn_node_unperm[node_order] = np.arange(g.n_vars, dtype=np.int32)
        cn_edge_var = g.cn_edge_var[cn_slots].astype(np.int64)

        return cls(
            n_vars=g.n_vars,
            n_checks=g.n_checks,
            n_edges=g.n_edges,
            d_c_max=g.d_c_max,
            d_v_max=g.d_v_max,
            data_len=g.data_len,
            code_rate=g.code_rate,
            cn_groups=specs(cn_groups_g),
            vn_groups=specs(vn_groups_g),
            to_vn=PermutationPlan.from_permutation(cn_pos_of_vn_edge),
            to_cn=PermutationPlan.from_permutation(vn_pos_of_cn_edge),
            cn_edge_var=jnp.asarray(cn_edge_var.astype(np.int32)),
            vn_node_unperm=jnp.asarray(vn_node_unperm),
            seed_plan=PermutationPlan.from_permutation(cn_edge_var),
            vn_gather_plan=PermutationPlan.from_permutation(node_order),
            vn_unperm_plan=PermutationPlan.from_permutation(
                vn_node_unperm.astype(np.int64)
            ),
        )
