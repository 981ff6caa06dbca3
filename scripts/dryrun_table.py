"""The [dryrun] lines of ``scripts/dryrun_all.sh`` as a Markdown table: one
row an (arch x shape), for each mesh its argument and temp GiB a card,
whether they fit in one H100's 79.18 GiB (torch's total capacity of the
80 GB card), the counted FLOPs over ``model_flops``, and the roofline's
compute and memory seconds and which dominates. Then the failures, and
the trace seconds by mesh.

  PYTHONPATH=src python scripts/dryrun_table.py dryrun_all.log [...]
"""
import re
import sys

from repro_torch.configs import ASSIGNED_ARCHS, INPUT_SHAPES

CARD_GIB = 79.18
LINE = re.compile(r"\[dryrun\] (\S+)\s+(\S+)\s+mesh=(\S+)\s+trace=\s*([\d.]+)s "
                  r"args/dev=\s*([\d.]+)GiB temp/dev=\s*([\d.]+)GiB flops/dev=\S+ "
                  r"useful=(\S+) t_comp=\s*(\S+)ms t_mem=\s*(\S+)ms dom=(\w+)")
FAIL = re.compile(r"\[dryrun\] FAIL (\S+) (\S+): (.*)")


def main(paths):
    rows, fails, meshes = {}, [], []
    for path in paths:
        for line in open(path):
            if m := LINE.search(line):
                arch, shape, mesh, trace, *rest = m.groups()
                rows[arch, shape, mesh] = (float(trace), *map(float, rest[:5]), rest[5])
                meshes += [mesh] if mesh not in meshes else []
            elif m := FAIL.search(line):
                fails.append(m.groups())

    meshes.sort(key=lambda m: -eval("*".join(re.findall(r"\d+", m))))  # most cards first

    def cell(key):
        if key not in rows:
            return "fails | | | |"
        _, args, temp, useful, comp_ms, mem_ms, dom = rows[key]
        fits = "yes" if args + temp <= CARD_GIB else "no"
        return (f"{args:.2f} | {temp:.2f} | {fits} | {1 / useful:.3g} | "
                f"{comp_ms / 1e3:.3g} / {mem_ms / 1e3:.3g} {dom[:3]}")

    heads = " | ".join(f"{m}: args | temp | fits | FLOPs / model | compute / memory s"
                       for m in meshes)
    print(f"| arch | shape | {heads} |")
    print("|---|---|" + "---|" * 5 * len(meshes))
    for arch, shape in ((a, s) for a in ASSIGNED_ARCHS for s in INPUT_SHAPES):
        print(f"| {arch} | {shape} | " + " | ".join(cell((arch, shape, m)) for m in meshes) + " |")
    for arch, shape, why in dict.fromkeys(fails):
        print(f"fails: {arch} {shape}: {why}")
    for m in meshes:
        print(f"trace s, {m}: total {sum(r[0] for k, r in rows.items() if k[2] == m):.1f}; "
              + ", ".join(f"{k[0]} {k[1]} {r[0]}" for k, r in rows.items()
                          if k[2] == m and r[0] >= 60))


if __name__ == "__main__":
    main(sys.argv[1:])
