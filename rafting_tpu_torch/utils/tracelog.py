"""Flight-recorder event taxonomy of the port.

The port's own copy of the ``TR_*`` event kinds and ``TRACE_EVENTS`` of
``rafting_tpu/utils/tracelog.py``: ``core/step.py`` and
``core/types.crash_restart`` stamp these kinds into the per-group rings,
so one ring decodes the same whichever engine wrote it.  The host-side
drain and decoder (``TraceLog``, ``decode_group``, dumps) are not ported
yet; they come with the node runtime.

Aux payload per kind (see ``core/step.py``'s flight recorder):
TERM_BUMP the previous term; STEPPED_DOWN the leader known at the end of
the tick; BECAME_CANDIDATE the cause (0 PreVote majority, 1 timer, 2
TimeoutNow); BECAME_LEADER the no-op index; SNAPSHOT_INSTALL the
milestone; COMMIT_ADVANCE the new commit; READ_RELEASE the reads served;
CRASH_RESTART the durable log tail; CONF_CHANGE_ENTER the new config
word; CONF_CHANGE_COMMIT the config entry's index; LEADER_TRANSFER the
target peer.
"""

TR_TERM_BUMP = 1
TR_STEPPED_DOWN = 2
TR_BECAME_PRE_CANDIDATE = 3
TR_BECAME_CANDIDATE = 4
TR_BECAME_LEADER = 5
TR_SNAPSHOT_INSTALL = 6
TR_COMMIT_ADVANCE = 7
TR_READ_RELEASE = 8
TR_CRASH_RESTART = 9
TR_CONF_CHANGE_ENTER = 10
TR_CONF_CHANGE_COMMIT = 11
TR_LEADER_TRANSFER = 12

TRACE_EVENTS = {
    TR_TERM_BUMP: "TERM_BUMP",
    TR_STEPPED_DOWN: "STEPPED_DOWN",
    TR_BECAME_PRE_CANDIDATE: "BECAME_PRE_CANDIDATE",
    TR_BECAME_CANDIDATE: "BECAME_CANDIDATE",
    TR_BECAME_LEADER: "BECAME_LEADER",
    TR_SNAPSHOT_INSTALL: "SNAPSHOT_INSTALL",
    TR_COMMIT_ADVANCE: "COMMIT_ADVANCE",
    TR_READ_RELEASE: "READ_RELEASE",
    TR_CRASH_RESTART: "CRASH_RESTART",
    TR_CONF_CHANGE_ENTER: "CONF_CHANGE_ENTER",
    TR_CONF_CHANGE_COMMIT: "CONF_CHANGE_COMMIT",
    TR_LEADER_TRANSFER: "LEADER_TRANSFER",
}
