"""Data kind ``scan_sequence``: ``scans`` consecutive scans of ``points``
points (``synth_cloud`` scenes, one seed each from the run's seed); pair p
registers scan p + 1 (source) onto scan p (target), each pair under
``perturbations`` initial poses, so a call carries ``pairs *
perturbations`` registrations. The program gets the scans as clouds in
xyz Morton order and one kd index per target, as its command line does;
the reference gets the raw scans and orders them itself."""

from __future__ import annotations

from benchmark.harness import synth
from benchmark.harness.cells import SCAN_STREAM, Cell, call_seed, port_config
from benchmark.harness.spec import icp_settings, mix_seed


def build(config: dict, traffic: dict, seed: int, device, entry) -> Cell:
    from icp_variants_tpu_torch.core import cloud as cloud_lib
    from icp_variants_tpu_torch.ops import kdtree
    from icp_variants_tpu_torch.pipeline import icp

    data = config["data"]
    settings = icp_settings(config, traffic)
    cfg = port_config(settings, config.get("camera"))
    n_pairs, per_pair = traffic["pairs"], traffic["perturbations"]
    if n_pairs + 1 > data["scans"]:
        raise ValueError(f"{n_pairs} pairs need {n_pairs + 1} scans, the sequence has {data['scans']}")
    scans = [synth.synth_cloud(data["points"], mix_seed(seed, k, SCAN_STREAM))
             for k in range(n_pairs + 1)]
    host = [cloud_lib.from_numpy(p, normals=n, morton_order=True, device="cpu") for p, n in scans]
    kd = [icp.build_kd_for(cfg, c, device=device) for c in host[:-1]]
    on_card = [c.to(device) for c in host]
    rows = [p for p in range(n_pairs) for _ in range(per_pair)]
    sources = icp.stack_clouds([on_card[p + 1] for p in rows])
    targets = icp.stack_clouds([on_card[p] for p in rows])
    kd_indexes = None if kd[0] is None else kdtree.stack_kd_indexes([kd[p] for p in rows])
    del on_card
    batch = len(rows)

    def reference_inputs(i: int, j: int, device) -> dict:
        from benchmark.reference import derive, icp as ref

        p = rows[j]
        source = derive.padded_cloud(*scans[p + 1], morton_order=True)
        target = derive.padded_cloud(*scans[p], morton_order=True)
        draws = None
        if settings.get("selection") == "RANDOM":
            draws = ref.gap_draws(call_seed(seed, i), batch, j, source["points"].shape[0],
                                  settings["selection_proba"], settings["n_iterations"], device)
        return {"source": source, "target": target, "draws": draws}

    return Cell.make(config, traffic, seed, device, cfg, settings, entry, sources, targets,
                     kd_indexes, batch, reference_inputs)
