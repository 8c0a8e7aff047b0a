"""One process of the true multi-process integration check (VERDICT r4
item 3): N ``jax.distributed``-initialized CPU processes drive

    striped SnapshotEAGLE(process_index=...) file reads
    -> parallel.sharded_io global-array assembly
    -> particle-sharded render over the global mesh (psum over ICI-analog)
    -> cross-process digest consistency + dense-oracle fidelity

exercising every ``jax.process_index() > 0`` code path (file striping,
allgathered lengths, make_array_from_process_local_data, collective
reduction) that single-process virtual-device tests cannot reach.

Reference behaviour being replaced: rank-parallel pyread_eagle reads +
MPI gather (`io/EAGLE/_SnapshotEAGLE.py:119-130`,
`tools/_ArrayReorder.py:262-656`).

Run via run_multiprocess.sh, not directly.
"""

import argparse
import os
import sys

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", ".."))
sys.path.insert(0, REPO)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--process-id", type=int, required=True)
    ap.add_argument("--num-processes", type=int, required=True)
    ap.add_argument("--coordinator", required=True)
    ap.add_argument("--data-dir", required=True)
    ap.add_argument("--devices-per-process", type=int, default=4)
    args = ap.parse_args()

    os.environ["XLA_FLAGS"] = (
        os.environ.get("XLA_FLAGS", "")
        + f" --xla_force_host_platform_device_count={args.devices_per_process}"
    )
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_cpu_collectives_implementation", "gloo")
    jax.distributed.initialize(
        coordinator_address=args.coordinator,
        num_processes=args.num_processes,
        process_id=args.process_id,
    )
    assert jax.process_count() == args.num_processes
    n_dev = args.num_processes * args.devices_per_process
    assert len(jax.devices()) == n_dev, (len(jax.devices()), n_dev)

    import numpy as np
    import jax.numpy as jnp
    from jax.sharding import Mesh

    from astro_sph_tools_tpu.data_structures import ParticleType
    from astro_sph_tools_tpu.io.eagle import SnapshotEAGLE
    from astro_sph_tools_tpu.ops.deposit import MapSpec
    from astro_sph_tools_tpu.parallel.sharded import deposit_2d_sharded
    from astro_sph_tools_tpu.parallel.sharded_io import (
        load_particle_fields_sharded,
        open_process_local_snapshot,
    )
    from astro_sph_tools_tpu.utils.determinism import (
        assert_consistent_across_processes,
        hash_array,
    )

    with open(os.path.join(args.data_dir, "path.txt")) as f:
        snap_path = f.read().strip()

    # 1. striped read: this process opens only its slice of the file set
    snap = open_process_local_snapshot(SnapshotEAGLE, snap_path)
    assert len(snap._my_files) < len(snap._file_paths), (
        "striping must hand each process a strict subset of files"
    )
    n_local = snap.number_of_particles_this_rank(ParticleType.gas)
    n_total = snap.number_of_particles(ParticleType.gas)

    # 2. global sharded assembly over the full multi-process mesh
    mesh = Mesh(np.asarray(jax.devices()).reshape(n_dev), ("data",))
    fields = load_particle_fields_sharded(
        snap, ParticleType.gas,
        ["positions", "smoothing_lengths", "masses"], mesh,
        pad_to_multiple=512,
    )
    pos = fields["positions"]
    assert pos.shape[0] % n_dev == 0
    # the global array really spans processes: each process only addresses
    # its own shards
    addressable = sum(
        s.data.shape[0] for s in pos.addressable_shards
    )
    assert addressable == pos.shape[0] // args.num_processes

    # 3. even shard rebalance across PROCESSES (the all_to_all rides the
    # gloo cross-process collective — single-process virtual-device tests
    # cannot reach this path)
    from astro_sph_tools_tpu.parallel import rebalance_evenly

    from jax.experimental import multihost_utils

    all_counts = np.asarray(
        multihost_utils.process_allgather(np.asarray(n_local))
    ).reshape(-1)
    shard_len = pos.shape[0] // n_dev
    dev_per_proc = args.devices_per_process
    dev_counts = np.concatenate([
        np.clip(c - np.arange(dev_per_proc) * shard_len, 0, shard_len)
        for c in all_counts
    ])
    (bx, by, bh, bm), new_counts = rebalance_evenly(
        [pos[:, 0], pos[:, 1], fields["smoothing_lengths"],
         fields["masses"]],
        dev_counts, mesh, pad_values=(0.0, 0.0, 1.0, 0.0),
    )
    assert int(new_counts.sum()) == n_total
    assert int(new_counts.max() - new_counts.min()) <= 1

    # 4. sharded render from the REBALANCED arrays: per-device partial
    # maps + psum
    box = float(snap.box_size.value[0])
    spec = MapSpec(shape=(64, 64), extent=(0.0, box, 0.0, box))
    img = deposit_2d_sharded(
        bx, by, bh, bm, spec, mesh, K=64,
    )
    img_local = np.asarray(img)  # fully replicated after psum

    # 4. every process must hold the bit-identical map
    assert_consistent_across_processes(img_local)

    # 5. fidelity: compare against the dense oracle over the FULL file set
    full = SnapshotEAGLE(snap_path)  # unstriped
    assert full.number_of_particles_this_rank(ParticleType.gas) == n_total
    x = full.get_positions(ParticleType.gas).to_value("Mpc")
    h = full.get_smoothing_lengths(ParticleType.gas).to_value("Mpc")
    m = full.get_masses(ParticleType.gas).to_value("Msun")
    sys.path.insert(0, os.path.join(REPO, "tests"))
    from oracles import project_oracle

    exp = project_oracle(
        x[:, 0].astype(np.float32), x[:, 1].astype(np.float32),
        h.astype(np.float32), m.astype(np.float32),
        spec.shape, spec.extent,
    )
    err = np.abs(img_local - exp).max() / exp.max()
    assert err < 1e-4, f"sharded render vs oracle: rel err {err}"

    # 6. striping covered everything exactly once (allgather of counts)
    from jax.experimental import multihost_utils

    all_local = np.asarray(
        multihost_utils.process_allgather(np.asarray(n_local))
    )
    assert all_local.sum() == n_total, (all_local, n_total)

    print(
        f"[proc {args.process_id}] OK: {n_local}/{n_total} gas local, "
        f"{n_dev}-device mesh, map digest {hash_array(img_local)[:12]}, "
        f"oracle err {err:.2e}",
        flush=True,
    )
    jax.distributed.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
