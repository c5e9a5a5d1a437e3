from tinyslam.frontend.orb import OrbFrontend  # noqa: F401
