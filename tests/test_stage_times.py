"""tools/stage_times.py: the reduction from a profiler trace to device
time per query stage (its trace-reading part runs on a GPU trace)."""
import os
import sys

import pytest

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "tools"))

import stage_times as T  # noqa: E402


@pytest.mark.parametrize("texts,want", [
    (["jit(f)/while/body/candidates/sort"], "candidates"),
    (["jit(f)/candidates/lca/reduce_or"], "lca"),          # innermost
    (["jit(f)/gather_decode/bucket_probe/gather"], "bucket_probe"),
    (["fusion.3", "jit(f)/jit(sketch_windows)/sketch/sort"], "sketch"),
    (["jit(f)/sketchy/candidatesX/add", ""], "other"),     # whole names
    ([], "other"),
])
def test_stage_of_takes_the_innermost_named_stage(texts, want):
    assert T.stage_of(texts) == want


def test_union_counts_overlap_once():
    assert T.union_ns([(0, 10), (5, 15), (20, 30), (21, 22)]) == 25
    assert T.union_ns([]) == 0


def test_hlo_op_names_from_optimized_dump(tmp_path):
    (tmp_path / "module_0001.jit_query_step_rows_scan.sm_9.0_gpu_after_"
                "optimizations.txt").write_text(
        "HloModule jit_query_step_rows_scan, entry_computation_layout={}\n"
        "\n"
        '  %sort.34 = s32[8192,4096]{1,0} sort(%p), dimensions={1}, '
        'metadata={op_name="jit(query_step_rows_scan)/while/body/'
        'candidates/sort" source_file="rows.py"}\n'
        '  ROOT %fusion.2 = s32[8]{0} fusion(%a), kind=kLoop, '
        'metadata={op_name="jit(query_step_rows_scan)/sketch/min"}\n'
        "  %p = s32[8]{0} parameter(0)\n")
    (tmp_path / "module_0001.jit_query_step_rows_scan.before_"
                "optimizations.txt").write_text("HloModule ignored\n")
    names = T.hlo_op_names(str(tmp_path))
    assert names == {
        ("jit_query_step_rows_scan", "sort.34"):
            "jit(query_step_rows_scan)/while/body/candidates/sort",
        ("jit_query_step_rows_scan", "fusion.2"):
            "jit(query_step_rows_scan)/sketch/min",
    }
    assert T.stage_of([names[("jit_query_step_rows_scan", "sort.34")]]) \
        == "candidates"
