"""The [dryrun] lines of ``scripts/dryrun_all.sh`` as a Markdown table: one
row an (arch x shape), for each mesh its argument and temp GiB a card,
whether they fit in one H100's 79.18 GiB (torch's total capacity of the
80 GB card), the counted FLOPs over ``model_flops``, the collective GiB a
card, and the roofline's compute, memory and collective seconds and which
dominates (collectives: "-" where the arch's trace counts none). Then the
failures, and the trace seconds by mesh.

  PYTHONPATH=src python scripts/dryrun_table.py dryrun_all.log [...]
"""
import re
import sys

from repro_torch.configs import ASSIGNED_ARCHS, INPUT_SHAPES

CARD_GIB = 79.18
LINE = re.compile(r"\[dryrun\] (\S+)\s+(\S+)\s+mesh=(\S+)\s+trace=\s*([\d.]+)s "
                  r"args/dev=\s*([\d.]+)GiB temp/dev=\s*([\d.]+)GiB flops/dev=\S+ "
                  r"useful=(\S+) t_comp=\s*(\S+)ms t_mem=\s*(\S+)ms "
                  r"(?:coll/dev=\s*([\d.]+)GiB t_coll=\s*(\S+)ms )?dom=(\w+)")
FAIL = re.compile(r"\[dryrun\] FAIL (\S+) (\S+): (.*)")


def main(paths):
    rows, fails, meshes = {}, [], []
    for path in paths:
        for line in open(path):
            if m := LINE.search(line):
                arch, shape, mesh, trace, *rest = m.groups()
                rows[arch, shape, mesh] = (float(trace), *map(float, rest[:5]),
                                           *(None if v is None else float(v) for v in rest[5:7]),
                                           rest[7])
                meshes += [mesh] if mesh not in meshes else []
            elif m := FAIL.search(line):
                fails.append(m.groups())

    meshes.sort(key=lambda m: -eval("*".join(re.findall(r"\d+", m))))  # most cards first

    def cell(key):
        if key not in rows:
            return "fails | | | | |"
        _, args, temp, useful, comp_ms, mem_ms, coll_gib, coll_ms, dom = rows[key]
        fits = "yes" if args + temp <= CARD_GIB else "no"
        coll = "-" if coll_gib is None else f"{coll_gib:.3g}"
        t_coll = "-" if coll_ms is None else f"{coll_ms / 1e3:.3g}"
        return (f"{args:.2f} | {temp:.2f} | {fits} | {1 / useful:.3g} | {coll} | "
                f"{comp_ms / 1e3:.3g} / {mem_ms / 1e3:.3g} / {t_coll} {dom[:4]}")

    heads = " | ".join(f"{m}: args | temp | fits | FLOPs / model | coll GiB | "
                       f"compute / memory / coll s" for m in meshes)
    print(f"| arch | shape | {heads} |")
    print("|---|---|" + "---|" * 6 * len(meshes))
    for arch, shape in ((a, s) for a in ASSIGNED_ARCHS for s in INPUT_SHAPES
                        if any((a, s, m) in rows for m in meshes)):
        print(f"| {arch} | {shape} | " + " | ".join(cell((arch, shape, m)) for m in meshes) + " |")
    for arch, shape, why in dict.fromkeys(fails):
        print(f"fails: {arch} {shape}: {why}")
    for m in meshes:
        print(f"trace s, {m}: total {sum(r[0] for k, r in rows.items() if k[2] == m):.1f}; "
              + ", ".join(f"{k[0]} {k[1]} {r[0]}" for k, r in rows.items()
                          if k[2] == m and r[0] >= 60))


if __name__ == "__main__":
    main(sys.argv[1:])
