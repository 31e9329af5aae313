# -*- coding: utf-8 -*-
# Generated by the protocol buffer compiler.  DO NOT EDIT!
# source: tpuft.proto
"""Generated protocol buffer code."""
from google.protobuf.internal import builder as _builder
from google.protobuf import descriptor as _descriptor
from google.protobuf import descriptor_pool as _descriptor_pool
from google.protobuf import symbol_database as _symbol_database
# @@protoc_insertion_point(imports)

_sym_db = _symbol_database.Default()




DESCRIPTOR = _descriptor_pool.Default().AddSerializedFile(b'\n\x0btpuft.proto\x12\x05tpuft\"\x1f\n\tTimestamp\x12\x12\n\nunix_nanos\x18\x01 \x01(\x03\"\xa8\x01\n\x0cQuorumMember\x12\x12\n\nreplica_id\x18\x01 \x01(\t\x12\x0f\n\x07\x61\x64\x64ress\x18\x02 \x01(\t\x12\x15\n\rstore_address\x18\x03 \x01(\t\x12\x0c\n\x04step\x18\x04 \x01(\x03\x12\x12\n\nworld_size\x18\x05 \x01(\x04\x12\x13\n\x0bshrink_only\x18\x06 \x01(\x08\x12\x17\n\x0f\x63ommit_failures\x18\x07 \x01(\x04\x12\x0c\n\x04\x64\x61ta\x18\x08 \x01(\t\"i\n\x06Quorum\x12\x11\n\tquorum_id\x18\x01 \x01(\x03\x12)\n\x0cparticipants\x18\x02 \x03(\x0b\x32\x13.tpuft.QuorumMember\x12!\n\x07\x63reated\x18\x03 \x01(\x0b\x32\x10.tpuft.Timestamp\"U\n\x17LighthouseQuorumRequest\x12&\n\trequester\x18\x01 \x01(\x0b\x32\x13.tpuft.QuorumMember\x12\x12\n\ntimeout_ms\x18\x02 \x01(\x03\"9\n\x18LighthouseQuorumResponse\x12\x1d\n\x06quorum\x18\x01 \x01(\x0b\x32\r.tpuft.Quorum\"0\n\x1aLighthouseHeartbeatRequest\x12\x12\n\nreplica_id\x18\x01 \x01(\t\"\x1d\n\x1bLighthouseHeartbeatResponse\"\x19\n\x17LighthouseStatusRequest\"^\n\x0cMemberStatus\x12#\n\x06member\x18\x01 \x01(\x0b\x32\x13.tpuft.QuorumMember\x12\x18\n\x10heartbeat_age_ms\x18\x02 \x01(\x01\x12\x0f\n\x07joining\x18\x03 \x01(\x08\"{\n\x18LighthouseStatusResponse\x12\x11\n\tquorum_id\x18\x01 \x01(\x03\x12$\n\x07members\x18\x02 \x03(\x0b\x32\x13.tpuft.MemberStatus\x12\x12\n\nhas_quorum\x18\x03 \x01(\x08\x12\x12\n\nchange_log\x18\x04 \x01(\t\"/\n\x0bKillRequest\x12\x12\n\nreplica_id\x18\x01 \x01(\t\x12\x0c\n\x04mode\x18\x02 \x01(\t\"\x0e\n\x0cKillResponse\"\xaa\x01\n\x14ManagerQuorumRequest\x12\x12\n\ngroup_rank\x18\x01 \x01(\x03\x12\x0c\n\x04step\x18\x02 \x01(\x03\x12\x1b\n\x13\x63heckpoint_metadata\x18\x03 \x01(\t\x12\x13\n\x0bshrink_only\x18\x04 \x01(\x08\x12\x11\n\tinit_sync\x18\x05 \x01(\x08\x12\x17\n\x0f\x63ommit_failures\x18\x06 \x01(\x04\x12\x12\n\ntimeout_ms\x18\x07 \x01(\x03\"\xc8\x03\n\x15ManagerQuorumResponse\x12\x11\n\tquorum_id\x18\x01 \x01(\x03\x12\x1d\n\x06quorum\x18\x02 \x01(\x0b\x32\r.tpuft.Quorum\x12\x14\n\x0creplica_rank\x18\x03 \x01(\x03\x12\x1a\n\x12replica_world_size\x18\x04 \x01(\x03\x12(\n\x1brecover_src_manager_address\x18\x05 \x01(\tH\x00\x88\x01\x01\x12%\n\x18recover_src_replica_rank\x18\x06 \x01(\x03H\x01\x88\x01\x01\x12!\n\x19recover_dst_replica_ranks\x18\x07 \x03(\x03\x12\x15\n\rstore_address\x18\x08 \x01(\t\x12\x10\n\x08max_step\x18\t \x01(\x03\x12\x1d\n\x10max_replica_rank\x18\n \x01(\x03H\x02\x88\x01\x01\x12\x16\n\x0emax_world_size\x18\x0b \x01(\x03\x12\x0c\n\x04heal\x18\x0c \x01(\x08\x12\x17\n\x0f\x63ommit_failures\x18\r \x01(\x04\x42\x1e\n\x1c_recover_src_manager_addressB\x1b\n\x19_recover_src_replica_rankB\x13\n\x11_max_replica_rank\"C\n\x19\x43heckpointMetadataRequest\x12\x12\n\ngroup_rank\x18\x01 \x01(\x03\x12\x12\n\ntimeout_ms\x18\x02 \x01(\x03\"9\n\x1a\x43heckpointMetadataResponse\x12\x1b\n\x13\x63heckpoint_metadata\x18\x01 \x01(\t\"b\n\x13ShouldCommitRequest\x12\x12\n\ngroup_rank\x18\x01 \x01(\x03\x12\x0c\n\x04step\x18\x02 \x01(\x03\x12\x15\n\rshould_commit\x18\x03 \x01(\x08\x12\x12\n\ntimeout_ms\x18\x04 \x01(\x03\"-\n\x14ShouldCommitResponse\x12\x15\n\rshould_commit\x18\x01 \x01(\x08\"-\n\x0fStoreSetRequest\x12\x0b\n\x03key\x18\x01 \x01(\t\x12\r\n\x05value\x18\x02 \x01(\x0c\"\x12\n\x10StoreSetResponse\"@\n\x0fStoreGetRequest\x12\x0b\n\x03key\x18\x01 \x01(\t\x12\x0c\n\x04wait\x18\x02 \x01(\x08\x12\x12\n\ntimeout_ms\x18\x03 \x01(\x03\"0\n\x10StoreGetResponse\x12\r\n\x05\x66ound\x18\x01 \x01(\x08\x12\r\n\x05value\x18\x02 \x01(\x0c\"-\n\x0fStoreAddRequest\x12\x0b\n\x03key\x18\x01 \x01(\t\x12\r\n\x05\x64\x65lta\x18\x02 \x01(\x03\"!\n\x10StoreAddResponse\x12\r\n\x05value\x18\x01 \x01(\x03\"!\n\x12StoreDeleteRequest\x12\x0b\n\x03key\x18\x01 \x01(\t\"&\n\x13StoreDeleteResponse\x12\x0f\n\x07\x64\x65leted\x18\x01 \x01(\x08\"\x84\x01\n\x14QuorumSimParticipant\x12#\n\x06member\x18\x01 \x01(\x0b\x32\x13.tpuft.QuorumMember\x12\x15\n\rjoined_age_ms\x18\x02 \x01(\x04\x12\x18\n\x10heartbeat_age_ms\x18\x03 \x01(\x04\x12\x16\n\x0eheartbeat_only\x18\x04 \x01(\x08\"\xb6\x01\n\x10QuorumSimRequest\x12\x31\n\x0cparticipants\x18\x01 \x03(\x0b\x32\x1b.tpuft.QuorumSimParticipant\x12\"\n\x0bprev_quorum\x18\x02 \x01(\x0b\x32\r.tpuft.Quorum\x12\x14\n\x0cmin_replicas\x18\x04 \x01(\x04\x12\x17\n\x0fjoin_timeout_ms\x18\x05 \x01(\x04\x12\x1c\n\x14heartbeat_timeout_ms\x18\x06 \x01(\x04\"b\n\x11QuorumSimResponse\x12\x12\n\nhas_quorum\x18\x01 \x01(\x08\x12)\n\x0cparticipants\x18\x02 \x03(\x0b\x32\x13.tpuft.QuorumMember\x12\x0e\n\x06reason\x18\x03 \x01(\tb\x06proto3')

_builder.BuildMessageAndEnumDescriptors(DESCRIPTOR, globals())
_builder.BuildTopDescriptorsAndMessages(DESCRIPTOR, 'tpuft_pb2', globals())
if _descriptor._USE_C_DESCRIPTORS == False:

  DESCRIPTOR._options = None
  _TIMESTAMP._serialized_start=22
  _TIMESTAMP._serialized_end=53
  _QUORUMMEMBER._serialized_start=56
  _QUORUMMEMBER._serialized_end=224
  _QUORUM._serialized_start=226
  _QUORUM._serialized_end=331
  _LIGHTHOUSEQUORUMREQUEST._serialized_start=333
  _LIGHTHOUSEQUORUMREQUEST._serialized_end=418
  _LIGHTHOUSEQUORUMRESPONSE._serialized_start=420
  _LIGHTHOUSEQUORUMRESPONSE._serialized_end=477
  _LIGHTHOUSEHEARTBEATREQUEST._serialized_start=479
  _LIGHTHOUSEHEARTBEATREQUEST._serialized_end=527
  _LIGHTHOUSEHEARTBEATRESPONSE._serialized_start=529
  _LIGHTHOUSEHEARTBEATRESPONSE._serialized_end=558
  _LIGHTHOUSESTATUSREQUEST._serialized_start=560
  _LIGHTHOUSESTATUSREQUEST._serialized_end=585
  _MEMBERSTATUS._serialized_start=587
  _MEMBERSTATUS._serialized_end=681
  _LIGHTHOUSESTATUSRESPONSE._serialized_start=683
  _LIGHTHOUSESTATUSRESPONSE._serialized_end=806
  _KILLREQUEST._serialized_start=808
  _KILLREQUEST._serialized_end=855
  _KILLRESPONSE._serialized_start=857
  _KILLRESPONSE._serialized_end=871
  _MANAGERQUORUMREQUEST._serialized_start=874
  _MANAGERQUORUMREQUEST._serialized_end=1044
  _MANAGERQUORUMRESPONSE._serialized_start=1047
  _MANAGERQUORUMRESPONSE._serialized_end=1503
  _CHECKPOINTMETADATAREQUEST._serialized_start=1505
  _CHECKPOINTMETADATAREQUEST._serialized_end=1572
  _CHECKPOINTMETADATARESPONSE._serialized_start=1574
  _CHECKPOINTMETADATARESPONSE._serialized_end=1631
  _SHOULDCOMMITREQUEST._serialized_start=1633
  _SHOULDCOMMITREQUEST._serialized_end=1731
  _SHOULDCOMMITRESPONSE._serialized_start=1733
  _SHOULDCOMMITRESPONSE._serialized_end=1778
  _STORESETREQUEST._serialized_start=1780
  _STORESETREQUEST._serialized_end=1825
  _STORESETRESPONSE._serialized_start=1827
  _STORESETRESPONSE._serialized_end=1845
  _STOREGETREQUEST._serialized_start=1847
  _STOREGETREQUEST._serialized_end=1911
  _STOREGETRESPONSE._serialized_start=1913
  _STOREGETRESPONSE._serialized_end=1961
  _STOREADDREQUEST._serialized_start=1963
  _STOREADDREQUEST._serialized_end=2008
  _STOREADDRESPONSE._serialized_start=2010
  _STOREADDRESPONSE._serialized_end=2043
  _STOREDELETEREQUEST._serialized_start=2045
  _STOREDELETEREQUEST._serialized_end=2078
  _STOREDELETERESPONSE._serialized_start=2080
  _STOREDELETERESPONSE._serialized_end=2118
  _QUORUMSIMPARTICIPANT._serialized_start=2121
  _QUORUMSIMPARTICIPANT._serialized_end=2253
  _QUORUMSIMREQUEST._serialized_start=2256
  _QUORUMSIMREQUEST._serialized_end=2438
  _QUORUMSIMRESPONSE._serialized_start=2440
  _QUORUMSIMRESPONSE._serialized_end=2538
# @@protoc_insertion_point(module_scope)
