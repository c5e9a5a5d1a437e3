import json

from tinyslam.utils.metrics import Metrics


def test_metrics_record_and_summary():
    m = Metrics()
    for i in range(10):
        m.step()
        m.record("inliers", 100 + i)
    s = m.summary()["inliers"]
    assert s["count"] == 10 and s["min"] == 100 and s["max"] == 109
    assert m.last("inliers") == 109


def test_metrics_timer_and_json(tmp_path):
    m = Metrics()
    with m.timer("stage"):
        pass
    assert m.last("stage_ms") >= 0
    p = tmp_path / "m.json"
    m.dump(p)
    data = json.loads(p.read_text())
    assert "stage_ms" in data
